"""The port's contiguous KV cache against the JAX reference on the same
weights: the in-place row writes, ``init_caches``, ``lm_apply`` over
contiguous rows (bucket prefill, then ragged decode), ``lm_apply`` past
2048 tokens (the blocked paths the 'auto' rule picks there), and the
engine's ``cache_mode='contiguous'`` (bucketed whole-prompt prefill,
per-slot rows, lockstep decode) on reduced qwen1.5-0.5b.

The reference runs its Pallas kernels in interpret mode here, as its own
tests do.  Tolerances (tests/test_torch_model.py says why): float logits
<= 1e-5, dual-mode logits <= 2e-3; float greedy token streams identical.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models import attention as J_attn
from repro.models import transformer as J_tf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.kernels import dispatch
from repro_torch.models import attention as T_attn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_caches, lm_apply
from repro_torch.serve import Request, ServeEngine

CONFIGS = {"float": ("float", "silu", "flash_pallas", 1e-5),
           "dualmode": ("dualmode", "silu_dualmode", "flash_pallas_int",
                        2e-3)}
REQS = [(0, [1, 2, 3, 4, 5], 5), (1, list(range(7, 30)), 6),
        (2, [4] * 10, 4), (5, [9, 9, 9], 0), (3, [2, 3], 3),
        (4, list(range(40, 52)), 2)]
KW = dict(n_slots=2, max_seq=96, prefill_buckets=(16, 32),
          cache_mode="contiguous", decode_attn_impl="flash_decode")


def _pair(sm, act, seed=0, **over):
    jcfg = J_registry.reduced_config("qwen1.5-0.5b").replace(
        softmax_impl=sm, activation=act, **over)
    tcfg = T_registry.reduced_config("qwen1.5-0.5b").replace(
        softmax_impl=sm, activation=act, **over)
    jp = J_tf.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def test_write_seq_matches_reference_in_place():
    """Scalar and per-row offsets, and the reference's clamp of a start
    past Smax - S; the port writes into the given buffer."""
    rs = np.random.RandomState(0)
    buf = rs.randn(3, 20, 2, 4).astype(np.float32)
    new = rs.randn(3, 5, 2, 4).astype(np.float32)
    for pos in (0, 7, 18, np.array([0, 9, 17], np.int32)):
        want = J_attn._write_seq(jnp.asarray(buf), jnp.asarray(new),
                                 jnp.asarray(pos))
        tb = torch.from_numpy(buf.copy())
        got = T_attn._write_seq(tb, torch.from_numpy(new), torch.as_tensor(
            pos) if isinstance(pos, np.ndarray) else pos)
        assert got is tb
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cache = {"k": torch.zeros(2, 8, 1, 3), "v": torch.zeros(2, 8, 1, 3)}
    kv = torch.ones(2, 2, 1, 3)
    assert T_attn._update_cache(cache, kv, 2 * kv, 3) is cache
    assert float(cache["v"][:, 3:5].min()) == 2.0
    assert float(cache["k"].sum()) == 2 * 2 * 3


def test_init_caches_layout():
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    caches = init_caches(cfg, 3, 40, device="cpu")
    assert len(caches) == cfg.n_layers
    for c in caches:
        for x in (c["kv"]["k"], c["kv"]["v"]):
            assert tuple(x.shape) == (3, 40, cfg.n_kv_heads, cfg.hd)
            assert not x.any()
    j = J_tf.init_caches(J_registry.reduced_config("qwen1.5-0.5b"), 3, 40)
    # the reference stacks the layers of the period on a leading axis
    assert tuple(j["periods"][0]["kv"]["k"].shape) == (cfg.n_layers, 3, 40,
                                                       cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("path", list(CONFIGS))
def test_contiguous_prefill_and_decode_match_reference(path):
    """A padded bucket prefill of two rows at 0, then one ragged decode
    step, through the blocked and the contiguous split-KV paths."""
    sm, act, blocked, tol = CONFIGS[path]
    jcfg, tcfg, jp, tp = _pair(sm, act, seed=1, attn_impl=blocked)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, jcfg.vocab, (2, 16))
    lens = np.array([16, 11], np.int32)
    jc = J_tf.init_caches(jcfg, 2, 48)
    tc = init_caches(tcfg, 2, 48, device="cpu")
    jl, jc, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32), pos=0,
                              caches=jc, last_pos=jnp.asarray(lens - 1))
    tl, tc = lm_apply(tp, tcfg, torch.from_numpy(toks), pos=0, caches=tc,
                      last_pos=torch.from_numpy(lens - 1), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    step = np.array([[5], [11]])
    jd = jcfg.replace(attn_impl="flash_decode")
    td = tcfg.replace(attn_impl="flash_decode")
    jl, _, _ = J_tf.lm_apply(jp, jd, jnp.asarray(step, jnp.int32),
                             pos=jnp.asarray(lens), caches=jc)
    tl, tc2 = lm_apply(tp, td, torch.from_numpy(step),
                       pos=torch.from_numpy(lens), caches=tc, device="cpu")
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


@pytest.mark.parametrize("path", list(CONFIGS))
def test_lm_apply_past_2048_tokens(path):
    """2049 tokens: 2049 x 2049 scores exceed 2**22, so 'auto' streams
    blocked.  The port runs the kernel's plain version ('flash_pallas'
    float, the snapped 'flash_pallas_int' dual-mode); the reference runs
    its blocked graph (float) and the whole-row snapped unit (dual-mode).
    One layer of one head keeps the reference's whole-row scores small."""
    sm, act, blocked, tol = CONFIGS[path]
    jcfg, tcfg, jp, tp = _pair(sm, act, seed=2, n_layers=1, n_heads=1,
                               n_kv_heads=1)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab, (1, 2049))
    if sm == "float":
        tcfg = tcfg.replace(attn_impl=blocked)
    else:
        jcfg = jcfg.replace(attn_impl="naive", softmax_impl="dualmode_snap")
        assert dispatch.resolve_attention("auto", 2049, 2049, sm,
                                          device="cpu") == blocked
    jl, _, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32),
                             last_pos=jnp.asarray([2048]))
    tl, _ = lm_apply(tp, tcfg, torch.from_numpy(toks),
                     last_pos=torch.tensor([2048]), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


def _engines(sm, act, blocked):
    jcfg, tcfg, jp, tp = _pair(sm, act)
    return (JEngine(jcfg, jp, prefill_attn_impl=blocked, **KW),
            ServeEngine(tcfg, tp, prefill_attn_impl=blocked, device="cpu",
                        **KW))


def test_contiguous_engine_float_streams_identical_to_reference():
    je, te = _engines("float", "silu", "flash_pallas")
    assert je.cache_mode == te.cache_mode == "contiguous"
    assert te.prefill_attn_impl == je.prefill_attn_impl == "flash_pallas"
    assert te.decode_attn_impl == je.decode_attn_impl == "flash_decode"
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    assert to == jo
    assert to[5] == [] and te.reasons[5] == "max_new"
    for key in ("prefills", "cache_copies", "admitted"):
        assert te.stats[key] == je.stats[key], key
    assert te.stats["numeric"] == 0 and te.active == 0


def test_contiguous_engine_dualmode_step_logits_track_reference():
    je, te = _engines("dualmode", "silu_dualmode", "flash_pallas_int")
    want = {"prefill": [], "decode": []}
    got = {"prefill": [], "decode": []}
    for key, attr in (("prefill", "_prefill"), ("decode", "_decode")):
        fn = getattr(je, attr)

        def jwrapped(*a, _fn=fn, _key=key, **k):
            res = _fn(*a, **k)
            want[_key].append(np.asarray(res[0]))
            return res
        setattr(je, attr, jwrapped)
    for key, attr in (("prefill", "prefill_logits"),
                      ("decode", "decode_logits")):
        fn = getattr(te, attr)

        def twrapped(*a, _fn=fn, _key=key, **k):
            res = _fn(*a, **k)
            got[_key].append(res.numpy().copy())
            return res
        setattr(te, attr, twrapped)
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    for key in ("prefill", "decode"):
        assert len(got[key]) == len(want[key]) > 0
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, atol=2e-3)
    assert to == jo


@pytest.mark.parametrize("sm", ["float", "dualmode"])
def test_long_context_engine_resolves_as_reference(sm):
    """max_seq 16384, buckets up to 4096: prefill resolves blocked, decode
    to the split-KV kernel, as the reference's engine resolves on its CPU
    backend (on a GPU the float pick is the kernel 'flash_pallas')."""
    jcfg, tcfg, jp, tp = _pair(sm, "silu")
    kw = dict(cache_mode="contiguous", max_seq=16384, n_slots=1,
              prefill_buckets=(512, 1024, 4096))
    je = JEngine(jcfg, jp, **kw)
    te = ServeEngine(tcfg, tp, device="cpu", **kw)
    assert (te.prefill_attn_impl, te.decode_attn_impl) == (
        je.prefill_attn_impl, je.decode_attn_impl) == (
        "flash" if sm == "float" else "flash_pallas_int", "flash_decode")
    assert te.buckets == je.buckets == (512, 1024, 4096)
    assert te._bucket(1000) == je._bucket(1000) == 1024


def test_serve_cli_contiguous(monkeypatch, capsys):
    from repro_torch.launch import serve as cli
    monkeypatch.setattr(sys, "argv", [
        "serve", "--reduced", "--device", "cpu", "--max-seq", "64",
        "--cache-mode", "contiguous", "--requests", "3", "--max-new", "3",
        "--decode-impl", "flash_decode"])
    cli.main()
    out = capsys.readouterr().out
    assert "cache=contiguous" in out and "decode=flash_decode" in out
    assert "3 requests, 9 tokens" in out
