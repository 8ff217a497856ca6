"""The port's model path held to the JAX reference on the same weights
(``params_from_numpy`` of the reference's ``init_lm``), and the copied
framework-free modules held to their originals.

Tolerances: float logits <= 1e-5 (f32 matmul / reduction orders).
Dual-mode logits <= 2e-3: the unit's words are identical on identical
inputs, but an attention score that lands within an ulp of an S5.10
quantize boundary can round to the neighbouring word when XLA and
PyTorch sum the q.k dot in different orders; one flipped score word
moves its probability by ~2^-10 relative, which the next layers carry
into the logits (measured here: ~1.4e-4).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models import attention as J_attn
from repro.models import transformer as J_tf
from repro.serve import paged_cache as J_paged_cache
from repro_torch.configs import registry as T_registry
from repro_torch.models import attention as T_attn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (init_lm, init_paged_caches,
                                            lm_apply)
from repro_torch.serve import paged_cache as T_paged_cache

REPO = Path(__file__).resolve().parents[1]

CONFIGS = {"float": ("float", "silu", 1e-5),
           "dualmode": ("dualmode", "silu_dualmode", 2e-3)}


@pytest.mark.parametrize("path", ["configs/base.py",
                                  "configs/qwen1_5_0_5b.py",
                                  "configs/yi_6b.py",
                                  "configs/bert_base.py",
                                  "configs/llama3_2_vision_11b.py",
                                  "configs/granite_moe_3b.py",
                                  "configs/whisper_base.py",
                                  "configs/minicpm3_4b.py",
                                  "configs/qwen3_14b.py",
                                  "configs/rwkv6_1_6b.py",
                                  "configs/jamba_v0_1_52b.py",
                                  "configs/deepseek_v2_lite_16b.py",
                                  "serve/paged_cache.py"])
def test_copied_modules_equal_originals(path):
    """Framework-free modules are ported by copy, byte for byte."""
    assert (REPO / "src/repro_torch" / path).read_text() == \
        (REPO / "src/repro" / path).read_text()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-6b", "bert-base",
                                  "llama-3.2-vision-11b",
                                  "granite-moe-3b-a800m", "whisper-base",
                                  "minicpm3-4b", "qwen3-14b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b", "deepseek-v2-lite-16b"])
def test_configs_equal_reference(arch):
    for get in ("get_config", "reduced_config"):
        j = getattr(J_registry, get)(arch)
        t = getattr(T_registry, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_block_pool_copy_behaves_as_original():
    """Same allocation, sharing and eviction sequence on both copies."""
    pools = [mod.BlockPool(6, 4) for mod in (J_paged_cache, T_paged_cache)]
    logs = []
    for pool, mod in zip(pools, (J_paged_cache, T_paged_cache)):
        h = mod.chain_hashes(list(range(12)), 4)
        a = pool.reserve(h[:2], 3)
        pool.register(h, a[0] + a[1])
        b = pool.reserve(h[:2], 3)
        grow = pool.ensure_reach(b[1], 9)
        for blk in a[0] + a[1] + b[0] + b[1]:
            pool.decref(blk)
        logs.append((a, b, grow, pool.available(), pool.in_use(), pool.hwm,
                     pool.alloc(5)))
    assert logs[0] == logs[1]


def _pair(sm, act, seed=0):
    jcfg = J_registry.reduced_config("qwen1.5-0.5b").replace(
        softmax_impl=sm, activation=act)
    tcfg = T_registry.reduced_config("qwen1.5-0.5b").replace(
        softmax_impl=sm, activation=act)
    jp = J_tf.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("path", list(CONFIGS))
def test_lm_apply_full_forward_matches_reference(path):
    sm, act, tol = CONFIGS[path]
    jcfg, tcfg, jp, tp = _pair(sm, act)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 24))
    jl, _, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32))
    tl, caches = lm_apply(tp, tcfg, torch.from_numpy(toks), device="cpu")
    assert caches is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


@pytest.mark.parametrize("path", list(CONFIGS))
def test_paged_prefill_and_decode_match_reference(path):
    """A chunk written through shuffled block tables, then one ragged
    decode step over two slots, on both sides (decode through the paged
    split-KV path: flash_decode)."""
    sm, act, tol = CONFIGS[path]
    jcfg, tcfg, jp, tp = _pair(sm, act, seed=1)
    bs, n_pool = 8, 9
    tables = np.array([[3, 7, 1, 0], [2, 8, 5, 0]], np.int32)
    rs = np.random.RandomState(1)
    chunks = [rs.randint(0, jcfg.vocab, (1, 12)), rs.randint(0, jcfg.vocab,
                                                              (1, 12))]
    jc = J_tf.init_paged_caches(jcfg, n_pool, bs)
    tc = init_paged_caches(tcfg, n_pool, bs, device="cpu")
    lens = [12, 9]
    for i, toks in enumerate(chunks):
        last = np.array([lens[i] - 1])
        jl, jc, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  pos=0, caches=jc,
                                  last_pos=jnp.asarray(last),
                                  paged=jnp.asarray(tables[i:i + 1]))
        tl, tc = lm_apply(tp, tcfg, torch.from_numpy(toks), pos=0,
                          caches=tc, last_pos=torch.from_numpy(last),
                          paged=torch.from_numpy(tables[i:i + 1]),
                          device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    step = np.array([[5], [11]])
    pos = np.array(lens, np.int32)
    dcfg_j = jcfg.replace(attn_impl="flash_decode")
    dcfg_t = tcfg.replace(attn_impl="flash_decode")
    jl, _, _ = J_tf.lm_apply(jp, dcfg_j, jnp.asarray(step, jnp.int32),
                             pos=jnp.asarray(pos), caches=jc,
                             paged=jnp.asarray(tables))
    tl, _ = lm_apply(tp, dcfg_t, torch.from_numpy(step),
                     pos=torch.from_numpy(pos), caches=tc,
                     paged=torch.from_numpy(tables), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


def test_paged_write_and_gather_match_reference():
    rs = np.random.RandomState(2)
    pool = rs.randn(13, 8, 2, 4).astype(np.float32)
    tables = (rs.permutation(12) + 1).reshape(3, 4).astype(np.int32)
    new = rs.randn(3, 13, 2, 4).astype(np.float32)
    for pos in (np.array([0, 3, 19], np.int32), 25):
        jp = J_attn.paged_write(jnp.asarray(pool), jnp.asarray(new),
                                jnp.asarray(pos), jnp.asarray(tables))
        tp = T_attn.paged_write(torch.from_numpy(pool.copy()),
                                torch.from_numpy(new),
                                torch.as_tensor(pos), torch.from_numpy(tables))
        # block 0 (the sentinel) takes colliding clamped writes in an
        # unspecified order on both sides: compare the live blocks
        np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
        np.testing.assert_array_equal(
            T_attn.paged_gather(tp, torch.from_numpy(tables)).numpy(),
            np.asarray(J_attn.paged_gather(jp, jnp.asarray(tables))))


def test_init_lm_distributions_and_layout():
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    p = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(np.asarray, J_tf.init_lm(
        jax.random.PRNGKey(0), J_registry.reduced_config("qwen1.5-0.5b")))
    conv = params_from_numpy(jp, cfg, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa
    assert shapes(p) == shapes(conv)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    w = p["layers"][0]["ffn"]["up"]["w"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert float(p["layers"][1]["mixer"]["wq"]["b"].abs().sum()) == 0.0


def test_entry_points_refuse_the_cpu_unless_asked():
    """No GPU and no explicit device='cpu': raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the GPU")
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg, torch.Generator().manual_seed(0))
    p = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_apply(p, cfg, torch.zeros((1, 3), dtype=torch.long))


def test_unported_configurations_raise():
    """Every config of the reference's registry is the port's (deepseek's
    since the prefix-layer slice), and a prefix layer of a spec the port
    does not run still raises -- at lm_apply as at init_lm."""
    from repro_torch.configs.base import LayerSpec
    assert sorted(T_registry.ARCH_IDS) == sorted(J_registry.ARCH_IDS)
    assert T_registry.get_config("deepseek-v2-lite-16b").prefix == (
        LayerSpec(mixer="mla", ffn="mlp"),)
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    p = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError):
        lm_apply(p, cfg.replace(prefix=(LayerSpec(mixer="rwkv", ffn="moe"),)),
                 torch.zeros((1, 3), dtype=torch.long), device="cpu")
    with pytest.raises(ValueError):
        T_registry.get_config("deepseek-v2-lite")


def test_flash_oracles_match_reference():
    """The plain blocked oracles: flash_attention (with its (m, l) stats,
    a ragged last block) and the split-merged form, float <= 1e-5."""
    from repro.models import flash as J_flash
    from repro_torch.models import flash as T_flash
    rs = np.random.RandomState(3)
    b, s, t, kh, g, h = 2, 5, 40, 2, 2, 8
    q = rs.randn(b, s, kh, g, h).astype(np.float32)
    k = rs.randn(b, t, kh, h).astype(np.float32)
    v = rs.randn(b, t, kh, h).astype(np.float32)
    q_pos = np.array([[3, 9, 17, 30, 39], [0, 1, 2, 3, 4]], np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 20:] = False
    jargs = dict(q_pos=jnp.asarray(q_pos), kv_valid=jnp.asarray(valid))
    targs = dict(q_pos=torch.from_numpy(q_pos),
                 kv_valid=torch.from_numpy(valid))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for a, b_ in zip(J_flash.flash_attention(jq, jk, jv, block=16,
                                             return_stats=True, **jargs),
                     T_flash.flash_attention(tq, tk, tv, block=16,
                                             return_stats=True, **targs)):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(
        T_flash.flash_attention_merged(tq, tk, tv, n_splits=4,
                                       **targs).numpy(),
        np.asarray(J_flash.flash_attention_merged(jq, jk, jv, n_splits=4,
                                                  **jargs)), atol=1e-5)
