"""The port's MLA (minicpm3-4b) and qk-norm (qwen3-14b) slices against the
JAX reference on the same weights and inputs: reduced minicpm3 through
``lm_apply`` (float, the unit's softmax, and its SiLU mode too), prefill
then decode on the contiguous and the paged latent caches, the paged and
contiguous engines against the JAX engine on tests/test_serve.py's
requests, the blocked and decode plain versions at hk != hv (MLA's q.k
width nope + rope against v's) against the reference's oracles; reduced
qwen3 through ``lm_apply`` dense and with the fused seams (the first test
of the qk-norm branch), and dual-mode block by block; the training
refusals of the encoder-decoder and MLA archs.

Tolerances: float logits 1e-5 (f32 orders); dual-mode logits 2e-3 (the
limit of tests/test_torch_model.py: a score or SiLU word within an ulp of
an S5.10 boundary can round to its neighbour when XLA and PyTorch sum a
dot in other orders).  qwen3's dual-mode blocks 2e-3 given the
reference's input, and its logits 5e-3, the bert / vision limit: with
qk-norm the reduced model's logits reach ~3.7 and a flipped word in its
first block carries into them (measured 7.4e-4 to 2.26e-3 over 4
seeds).  Prefill then decode against the full pass at the reference's
own 2e-4 (tests/test_models.py).  Plain attention versions 1e-5 (float)
and 1e-6 on grid-valued q and k (int).  Greedy engine streams identical.
"""
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models import transformer as J_tf
from repro.models.attention import _naive_sdpa as j_naive_sdpa
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels.flash_attention_int import \
    flash_attention_pallas_int
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

MLA = "minicpm3-4b"
QK = "qwen3-14b"
CPU = torch.device("cpu")
# name: (config overrides, logit limit)
MODES = {"float": ({}, 1e-5),
         "dualmode": (dict(softmax_impl="dualmode"), 2e-3),
         "silu_dualmode": (dict(softmax_impl="dualmode",
                                activation="silu_dualmode"), 2e-3)}

# the reference's functions, jitted (a config is static)
j_init_lm = jax.jit(J_tf.init_lm, static_argnums=1)
j_lm_apply = jax.jit(J_tf.lm_apply, static_argnums=1)
_naive_sdpa = jax.jit(j_naive_sdpa, static_argnames=("softmax_impl",))


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch):
    jcfg = J_registry.reduced_config(arch)
    np_params = jax.tree.map(np.asarray, j_init_lm(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, np_params


@pytest.fixture(scope="module")
def minicpm():
    return _pair(MLA)


@pytest.fixture(scope="module")
def qwen3():
    return _pair(QK)


def _tokens(cfg, seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape)


# ---------------- reduced minicpm3 ----------------

def test_mla_params_and_caches_follow_the_reference_layout(minicpm):
    jcfg, np_params = minicpm
    tcfg = T_registry.reduced_config(MLA)
    T_tf.check_supported(T_registry.get_config(MLA))
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    assert set(tp["layers"][0]["mixer"]) == {"wq_a", "q_norm", "wq_b",
                                             "wkv_a", "kv_norm", "wkv_b",
                                             "wo"}
    init = T_tf.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(np.shape, jax.tree.map(np.asarray, init))
    assert shapes == jax.tree.map(np.shape, jax.tree.map(np.asarray, tp))
    for mine, ref in ((T_tf.init_caches(tcfg, 3, 20, device=CPU),
                       J_tf.init_caches(jcfg, 3, 20)),
                      (T_tf.init_paged_caches(tcfg, 5, 8, device=CPU),
                       J_tf.init_paged_caches(jcfg, 5, 8))):
        assert set(mine[0]["kv"]) == {"ckv", "krope"}
        for name, x in mine[0]["kv"].items():
            assert tuple(x.shape) == ref["periods"][0]["kv"][name].shape[1:]


@pytest.mark.parametrize("mode", list(MODES))
def test_minicpm_lm_apply_matches_reference(minicpm, mode):
    over, tol = MODES[mode]
    jcfg, np_params = minicpm
    tcfg = T_registry.reduced_config(MLA).replace(**over)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = _tokens(jcfg)
    jl, _, _ = j_lm_apply(jax.tree.map(jnp.asarray, np_params),
                          jcfg.replace(**over), jnp.asarray(toks))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


@pytest.mark.parametrize("paged", [False, True])
def test_minicpm_prefill_then_decode_matches_full(minicpm, paged):
    """prefill(0..n) + decode(n) logits == prefill(0..n+1) last logits
    (tests/test_models.py's check at its 2e-4), on the contiguous latent
    rows and on the paged latent pools behind shuffled tables."""
    jcfg, np_params = minicpm
    tcfg = T_registry.reduced_config(MLA)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = _t(_tokens(jcfg, 3, (2, 9)))

    def caches():
        if paged:
            return T_tf.init_paged_caches(tcfg, 9, 8, device=CPU)
        return T_tf.init_caches(tcfg, 2, 32, device=CPU)
    tables = (torch.tensor([[3, 7, 1, 0], [2, 8, 5, 0]], dtype=torch.int32)
              if paged else None)
    c = caches()
    T_tf.lm_apply(tp, tcfg, toks[:, :8], pos=0, caches=c, paged=tables,
                  device=CPU)
    step, _ = T_tf.lm_apply(tp, tcfg, toks[:, 8:9], pos=8, caches=c,
                            paged=tables, device=CPU)
    full, _ = T_tf.lm_apply(tp, tcfg, toks, pos=0, caches=caches(),
                            paged=tables, device=CPU)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               atol=2e-4)


def test_minicpm_paged_chunk_and_decode_match_reference(minicpm):
    """A chunk a row through shuffled block tables, then a two-slot
    decode at ragged depths, against the reference's paged caches."""
    jcfg, np_params = minicpm
    jp = jax.tree.map(jnp.asarray, np_params)
    tcfg = T_registry.reduced_config(MLA)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    tables = np.array([[3, 7, 1, 0], [2, 8, 5, 0]], np.int32)
    jc = J_tf.init_paged_caches(jcfg, 9, 8)
    tc = T_tf.init_paged_caches(tcfg, 9, 8, device=CPU)
    lens = [12, 9]
    toks = _tokens(jcfg, 2, (2, 12))
    for i in range(2):
        last = np.array([lens[i] - 1])
        jl, jc, _ = j_lm_apply(jp, jcfg, jnp.asarray(toks[i:i + 1]), pos=0,
                               caches=jc, last_pos=jnp.asarray(last),
                               paged=jnp.asarray(tables[i:i + 1]))
        tl, tc = T_tf.lm_apply(tp, tcfg, _t(toks[i:i + 1]), pos=0,
                               caches=tc, last_pos=_t(last),
                               paged=_t(tables[i:i + 1]), device=CPU)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    step, pos = np.array([[5], [11]]), np.array(lens, np.int32)
    jl, jc, _ = j_lm_apply(jp, jcfg, jnp.asarray(step), pos=jnp.asarray(pos),
                           caches=jc, paged=jnp.asarray(tables))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(step), pos=_t(pos), caches=tc,
                          paged=_t(tables), device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[0]["kv"][name].numpy(),
                                   np.asarray(jc["periods"][0]["kv"][name][0]),
                                   atol=1e-5)


# tests/test_serve.py's requests and settings
REQS = [(0, [1, 2, 3, 4, 5], 5), (1, [7, 8, 9], 7), (2, [4] * 10, 4),
        (3, [2, 3], 3)]


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_minicpm_engine_streams_equal_reference(minicpm, mode):
    """3 slots, max_seq 48, buckets (8, 16): greedy streams token for
    token; the paged engine's latent pools drain."""
    jcfg, np_params = minicpm
    tcfg = T_registry.reduced_config(MLA)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    kw = dict(n_slots=3, max_seq=48, prefill_buckets=(8, 16),
              cache_mode=mode)
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **kw)
    te = ServeEngine(tcfg, tp, device=CPU, **kw)
    assert te.cache_mode == je.cache_mode == mode
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    assert to == jo
    assert te.stats["prefills"] == je.stats["prefills"] == 4
    assert te.active == 0
    if mode == "paged":
        assert te.pool.in_use() == 0


def test_minicpm_swap_moves_the_latent_pools(minicpm):
    """A pool too small for three decoding slots: preemption by swap
    copies every latent and rope-key row out and back, and the streams
    equal an ample pool's."""
    _, np_params = minicpm
    tcfg = T_registry.reduced_config(MLA)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    reqs = [(0, [1] * 8, 12), (1, [2] * 8, 12), (2, [3] * 9, 10)]
    kw = dict(n_slots=3, max_seq=48)

    def run(**extra):
        eng = ServeEngine(tcfg, tp, device=CPU, **kw, **extra)
        out = eng.run([Request(rid=r, prompt=p, max_new=n)
                       for r, p, n in reqs])
        return eng, out
    tight, out = run(num_blocks=6, preempt_mode="swap")
    _, ample = run()
    assert out == ample
    assert tight.stats["swap_outs"] >= 1 and tight.pool.in_use() == 0
    per_block = sum(x[0].numel() * x.element_size()
                    for layer in tight.caches for x in layer["kv"].values())
    assert tight.stats["swap_bytes"] % per_block == 0


# ---------------- the attention versions at hk != hv ----------------

def _case(seed, b, s, t, kh, h, hv, grid, q_pos=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, kh, 1, h)
    k = rs.randn(b, t, kh, h)
    if grid:                       # multiples of 2^-4: exact scores
        q, k = np.round(q * 4) / 16, np.round(k * 4) / 16
    v = rs.randn(b, t, kh, hv)
    if q_pos is None:
        q_pos = np.broadcast_to(np.arange(t - s, t)[None], (b, s))
    valid = np.arange(t)[None, :] <= np.asarray(q_pos).max(-1)[:, None]
    return (q.astype(np.float32), k.astype(np.float32), v.astype(np.float32),
            np.ascontiguousarray(q_pos, np.int32), valid)


def _mla_dims():
    m = T_registry.reduced_config(MLA)
    return m.n_heads, m.mla.nope_dim + m.mla.rope_dim, m.mla.v_dim


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


def _tt(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


@pytest.mark.parametrize("grid", [False, True])
def test_blocked_versions_at_mla_head_dims(grid):
    """Rows 7 / 8's plain versions at reduced MLA's K 4, G 1, h 24, hv
    16, causal over 70 keys: float against the reference's naive
    attention, int (grid-valued) against naive 'dualmode_snap'."""
    kh, h, hv = _mla_dims()
    q, k, v, qp, valid = _case(1, 2, 40, 70, kh, h, hv, grid)
    jargs = dict(q_pos=jnp.asarray(qp), kv_valid=jnp.asarray(valid))
    targs = dict(q_pos=torch.from_numpy(qp), kv_valid=torch.from_numpy(valid))
    if not grid:
        got = flash_attention_pallas(*_tt(q, k, v), block_kv=16, **targs)
        want = _naive_sdpa(*_j(q, k, v), **jargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        return
    got = flash_attention_pallas_int(*_tt(q, k, v), block_kv=16, **targs)
    want = _naive_sdpa(*_j(q, k, v), softmax_impl="dualmode_snap", **jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("grid", [False, True])
def test_decode_versions_at_mla_head_dims(grid):
    """Rows 5 / 6's plain versions at reduced MLA's K 4, G 1, h 24, hv
    16: one row per slot at ragged depths of a 100-key cache, 3 splits;
    float against the reference's naive attention, int (grid-valued)
    against naive 'dualmode_snap'."""
    kh, h, hv = _mla_dims()
    qp = np.array([[99], [40], [7]], np.int32)
    q, k, v, qp, valid = _case(2, 3, 1, 100, kh, h, hv, grid, q_pos=qp)
    valid = np.arange(100)[None, :] <= qp
    jargs = dict(q_pos=jnp.asarray(qp), kv_valid=jnp.asarray(valid))
    targs = dict(q_pos=torch.from_numpy(qp), kv_valid=torch.from_numpy(valid),
                 num_splits=3, block_kv=16)
    if not grid:
        got = fd.flash_decode_pallas(*_tt(q, k, v), **targs)
        want = _naive_sdpa(*_j(q, k, v), **jargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        return
    got = fd.flash_decode_pallas(*_tt(q, k, v), softmax_impl="dualmode",
                                 **targs)
    want = _naive_sdpa(*_j(q, k, v), softmax_impl="dualmode_snap", **jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------- reduced qwen3: qk-norm ----------------

@pytest.mark.parametrize("impls", ["dense", "fused"])
def test_qwen3_lm_apply_matches_reference(qwen3, impls):
    """The qk-norm branch (RMSNorm of every q and k head before RoPE),
    dense, and after the fused norm -> QKV prologue's split panel."""
    jcfg, np_params = qwen3
    tcfg = T_registry.reduced_config(QK)
    if impls == "fused":
        tcfg = tcfg.replace(norm_impl="fused_pallas", ffn_impl="fused_pallas")
    T_tf.check_supported(T_registry.get_config(QK))
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    assert set(tp["layers"][0]["mixer"]) == {"wq", "wk", "wv", "wo", "qn",
                                             "kn"}
    toks = _tokens(jcfg)
    jl, _, _ = j_lm_apply(jax.tree.map(jnp.asarray, np_params), jcfg,
                          jnp.asarray(toks))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    # the qk-norm gains reach the logits
    tp["layers"][0]["mixer"]["qn"]["g"].mul_(3.0)
    moved, _ = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    assert float((moved - tl).abs().max()) > 1e-3


def test_qwen3_dualmode_blocks_track_reference(qwen3):
    """Each dual-mode block given the reference's input, against the
    reference's block (2e-3), and the logits (5e-3; see the module
    docstring)."""
    jcfg, np_params = qwen3
    over = dict(softmax_impl="dualmode", activation="silu_dualmode")
    jcfg = jcfg.replace(**over)
    tcfg = T_registry.reduced_config(QK).replace(norm_impl="fused_pallas",
                                                 **over)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = _tokens(jcfg)
    pos = np.broadcast_to(np.arange(toks.shape[1])[None], toks.shape)

    @jax.jit
    def j_block(bp, x):
        ctx = J_tf.Ctx(positions=jnp.asarray(pos), pos=0)
        return J_tf.block_apply(bp, jcfg, jcfg.pattern[0], x, {}, ctx)[0]
    x = jp["embed"][jnp.asarray(toks)]
    for i in range(jcfg.n_layers):
        want = j_block(jax.tree.map(lambda a, i=i: a[i], jp["periods"][0]),
                       x)
        got, _, _ = T_tf.block_apply(tp["layers"][i], tcfg, tcfg.pattern[0],
                                     _t(x), None, positions=_t(pos), pos=0,
                                     paged=None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                                   err_msg=f"block {i}")
        x = want
    jl, _, _ = j_lm_apply(jp, jcfg, jnp.asarray(toks))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-3)


# ---------------- entry points ----------------

def test_check_supported_admits_exactly_this_slice():
    """MLA, an encoder stack and sinusoid positions are admitted (and,
    since the recurrent slice, jamba's mamba and rwkv6's rwkv layers;
    since the prefix-layer slice, deepseek-v2-lite's dense MLA prefix
    layer and its MLA over MoE); a prefix or a period of a spec the port
    does not run still raises."""
    from repro_torch.configs.base import LayerSpec
    for arch in (MLA, QK, "whisper-base", "jamba-v0.1-52b", "rwkv6-1.6b",
                 "deepseek-v2-lite-16b"):
        T_tf.check_supported(T_registry.get_config(arch))
    T_tf.check_supported(T_registry.reduced_config(QK).replace(
        pos_emb="sinusoid"))
    T_tf.check_supported(J_registry.get_config("deepseek-v2-lite-16b"))
    mla = T_registry.reduced_config(MLA)
    T_tf.check_supported(mla.replace(prefix=(LayerSpec(mixer="mla"),)))
    with pytest.raises(NotImplementedError):
        T_tf.check_supported(mla.replace(
            prefix=(LayerSpec(mixer="mla", ffn="moe", cross=True),)))
    with pytest.raises(NotImplementedError, match="mamba config"):
        T_tf.check_supported(mla.replace(prefix=(LayerSpec(mixer="mamba"),)))


@pytest.mark.parametrize("arch,why", [("whisper-base", "encdec"),
                                      (MLA, "MLA")])
def test_training_refuses_encdec_and_mla(arch, why):
    from repro_torch.launch import train as train_launch
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.train.step import check_train_arch
    tcfg = T_registry.reduced_config(arch)
    for call in (lambda: check_train_arch(tcfg),
                 lambda: make_train_step(tcfg, TrainConfig(), "cpu"),
                 lambda: Trainer(tcfg, TrainConfig(), 2, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match=why):
            call()
    argv = ["train", "--arch", arch, "--reduced", "--device", "cpu",
            "--steps", "1"]
    with mock.patch.object(sys, "argv", argv), \
            pytest.raises(NotImplementedError, match=why):
        train_launch.main()
    check_train_arch(T_registry.reduced_config(QK))


@pytest.mark.parametrize("arch", [MLA, QK])
def test_serve_launcher_takes_the_arch(arch, capsys):
    from repro_torch.launch import serve
    argv = ["serve", "--arch", arch, "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "2", "--max-seq", "64"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert f"[serve] {arch}" in out and "cache=paged" in out
