"""The port's serving engine against the JAX engine: reduced qwen1.5-0.5b,
paged cache, max_seq 128, decode forced through the paged split-KV path
('flash_decode') on both sides (the reference's Pallas kernel in
interpret mode, as tests/test_serve.py runs it).

Float: greedy token streams identical.  Dual-mode: per-step logits of the
prefill chunks and decode ticks held to the reference's at 2e-3 (see
tests/test_torch_model.py for why dual-mode logits are not bitwise),
then the token streams compared.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models.transformer import init_lm as j_init_lm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_lm
from repro_torch.serve import Request, ServeEngine

REQS = [(0, [1, 2, 3, 4, 5], 5), (1, list(range(7, 30)), 6),
        (2, [4] * 10, 4), (5, [9, 9, 9], 0), (3, [2, 3], 3),
        (4, list(range(40, 52)), 2)]
KW = dict(n_slots=2, max_seq=128, decode_attn_impl="flash_decode",
          prefill_chunk=8)


def _engines(sm, act):
    jcfg = J_registry.reduced_config("qwen1.5-0.5b").replace(
        softmax_impl=sm, activation=act)
    tcfg = T_registry.reduced_config("qwen1.5-0.5b").replace(
        softmax_impl=sm, activation=act)
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return JEngine(jcfg, jp, **KW), ServeEngine(tcfg, tp, device="cpu", **KW)


def test_float_token_streams_identical_to_reference():
    je, te = _engines("float", "silu")
    assert te.decode_attn_impl == je.decode_attn_impl == "flash_decode"
    assert te.prefill_attn_impl == je.prefill_attn_impl == "naive"
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    assert to == jo
    assert te.pool.in_use() == 0 and te.active == 0
    assert to[5] == [] and te.reasons[5] == "max_new"
    assert te.stats["prefills"] == je.stats["prefills"] == len(REQS) - 1
    assert te.stats["numeric"] == 0


def test_dualmode_step_logits_track_reference():
    je, te = _engines("dualmode", "silu_dualmode")
    got = {"prefill": [], "decode": []}

    def spy(engine, attr, key, out):
        fn = getattr(engine, attr)

        def wrapped(*a, **k):
            res = fn(*a, **k)
            out[key].append(np.asarray(res[0]))
            return res
        setattr(engine, attr, wrapped)

    want = {"prefill": [], "decode": []}
    spy(je, "_prefill", "prefill", want)
    spy(je, "_decode", "decode", want)
    spy_t = {"prefill": "prefill_chunk_logits", "decode": "decode_logits"}
    for key, attr in spy_t.items():
        fn = getattr(te, attr)

        def wrapped(*a, _fn=fn, _key=key, **k):
            res = _fn(*a, **k)
            got[_key].append(res.numpy().copy())
            return res
        setattr(te, attr, wrapped)
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    for key in ("prefill", "decode"):
        assert len(got[key]) == len(want[key]) > 0
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, atol=2e-3)
    assert to == jo
    assert te.pool.in_use() == 0


def test_prefix_sharing_and_eos():
    """Two prompts sharing full blocks share them; EOS retires early."""
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    p = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, p, n_slots=2, max_seq=64, block_size=8,
                      prefill_chunk=8, device="cpu")
    shared = list(range(1, 25))
    outs = eng.run([Request(rid=0, prompt=shared + [30], max_new=3)])
    eng2_first = outs[0][0]
    outs = eng.run([Request(rid=1, prompt=shared + [31], max_new=3)])
    assert eng.stats["shared_blocks"] == 3
    assert eng.pool.in_use() == 0
    e2 = ServeEngine(cfg, p, n_slots=1, max_seq=64, eos_id=eng2_first,
                     device="cpu")
    out = e2.run([Request(rid=0, prompt=shared + [30], max_new=10)])[0]
    assert out == [eng2_first] and e2.reasons[0] == "eos"


def test_pool_exhaustion_preempts_and_finishes():
    """A pool too small for both requests' decode growth preempts one of
    them, which resumes and finishes: every request gets its 9 tokens,
    the same as on an ample pool."""
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    p = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")

    def run(num_blocks):
        eng = ServeEngine(cfg, p, n_slots=2, max_seq=64, block_size=8,
                          num_blocks=num_blocks, prefill_chunk=8,
                          device="cpu")
        out = eng.run([Request(rid=0, prompt=[1] * 8, max_new=9),
                       Request(rid=1, prompt=[2] * 8, max_new=9)])
        assert eng.pool.in_use() == 0 and not eng.stats["starved"]
        return out, eng.stats["preemptions"]

    tight, preemptions = run(4)
    ample, none = run(None)
    assert preemptions >= 1 and none == 0
    assert all(len(tight[r]) == 9 for r in (0, 1))
    assert tight == ample


def test_engine_refuses_what_this_slice_does_not_serve():
    """What the port does not serve raises: the archs that are not dense
    attention + MLP (NotImplementedError), an unknown cache mode, a
    prompt past max_seq or the largest bucket (ValueError), and running
    on no GPU unasked (RuntimeError)."""
    from repro_torch.configs.base import LayerSpec
    cfg = T_registry.reduced_config("qwen1.5-0.5b")
    p = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg.replace(pattern=(LayerSpec(mixer="mamba"),)), p,
                    cache_mode="contiguous", device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(cfg, p, cache_mode="ring", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, p)
    eng = ServeEngine(cfg, p, max_seq=32, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[1] * 40))
    eng = ServeEngine(cfg, p, max_seq=64, cache_mode="contiguous",
                      prefill_buckets=(16, 32), device="cpu")
    assert eng.cache_mode == "contiguous" and eng.buckets == (16, 32)
    with pytest.raises(ValueError, match="largest bucket"):
        eng.submit(Request(rid=0, prompt=[1] * 40))


def test_paged_long_chunked_prefill_goes_blocked():
    """A 1024-token chunk against a 4224-key table is a blocked shape
    (over 2**22 scores): float resolves as the reference does on its CPU
    backend ('flash'; on a GPU the kernel 'flash_pallas') and streams
    identically; dual-mode resolves to the one-sweep int path and
    serves.  Decode is pinned to 'naive' on both sides: the reference's
    split-KV decode would run in interpret mode, and decode is not what
    this test is about."""
    kw = dict(n_slots=2, max_seq=4160, prefill_chunk=1024,
              decode_attn_impl="naive")
    reqs = [(0, list(range(1, 40)), 3), (1, [7] * 600, 2)]
    for sm, act in (("float", "silu"), ("dualmode", "silu_dualmode")):
        tcfg = T_registry.reduced_config("qwen1.5-0.5b").replace(
            softmax_impl=sm, activation=act)
        jcfg = J_registry.reduced_config("qwen1.5-0.5b").replace(
            softmax_impl=sm, activation=act)
        jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        te = ServeEngine(tcfg, tp, device="cpu", **kw)
        je = JEngine(jcfg, jp, **kw)
        assert te.prefill_attn_impl == je.prefill_attn_impl == (
            "flash" if sm == "float" else "flash_pallas_int")
        to = te.run([Request(rid=r, prompt=p, max_new=n)
                     for r, p, n in reqs])
        assert all(len(to[r]) == n for r, _, n in reqs)
        assert te.stats["numeric"] == 0 and te.pool.in_use() == 0
        if sm == "float":
            assert to == je.run([JRequest(rid=r, prompt=p, max_new=n)
                                 for r, p, n in reqs])
