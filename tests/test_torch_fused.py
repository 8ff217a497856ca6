"""The port's fused block seams against the JAX reference: the residual-
norm epilogue, the norm -> QKV prologue and the fused GLU (their plain
versions, which the wrappers run for CPU tensors), the ffn / norm
registries, and reduced yi-6b -- the bias-free GQA decoder whose QKV
projection takes the norm prologue -- through ``lm_apply`` and the paged
engine with the fused impls.

Same inputs on both sides, made with numpy.  Tolerances are the
reference's own (tests/test_fused_norm.py, tests/test_fused_ffn.py):
fused norms <= 1e-5 against the dense oracles, the GLU <= 2e-5 against
``_glu_reference``, the ``_FUSABLE_ACT`` entries at their per-entry
pins; f32 summation order is all that differs.  Model logits as in
tests/test_torch_model.py: float <= 1e-5, dual-mode <= 2e-3.  The
reference's Pallas kernels run in interpret mode in one tiny case each;
the CUDA kernels are held to these plain versions by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.kernels import datapath as J_dp
from repro.kernels import fused_ffn as J_ffn
from repro.kernels import fused_norm as J_norm
from repro.models import layers as J_layers
from repro.models import transformer as J_tf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_ffn as T_ffn
from repro_torch.kernels import fused_norm as T_norm
from repro_torch.models import layers as T_layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_lm, lm_apply
from repro_torch.serve import Request, ServeEngine

EPS = 1e-6
KINDS = ("rms", "layer")
# (m, d, widths): even tiles, and everything ragged (M, d, each width)
SHAPES = [(64, 128, (128, 64, 64)), (23, 72, (40, 24, 17))]
CONFIGS = {"float": ("float", "silu", 1e-5),
           "dualmode": ("dualmode", "silu_dualmode", 2e-3)}
FUSED = dict(norm_impl="fused_pallas", ffn_impl="fused_pallas")


def _data(m, d, widths, kind, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    r = rng.normal(size=(m, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    b = ((0.1 * rng.normal(size=(d,))).astype(np.float32)
         if kind == "layer" else None)
    ws = [(rng.normal(size=(d, n)) / d ** 0.5).astype(np.float32)
          for n in widths]
    return x, r, g, b, ws


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _dense_norm(x, g, b, kind):
    """The reference's dense oracle of both norm kinds."""
    if kind == "rms":
        return J_dp.rmsnorm(x, g, EPS)
    return J_dp.layernorm(x, g, b, EPS)


# ---------------- plain versions vs the dense oracles ----------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,d,widths", SHAPES)
def test_residual_norm_plain_vs_dense(kind, m, d, widths):
    x, r, g, b, _ = _data(m, d, widths, kind)
    xo, ho = T_norm.fused_residual_norm(_t(x), _t(r), _t(g), _t(b),
                                        kind=kind, eps=EPS)
    s = jnp.asarray(x) + jnp.asarray(r)
    np.testing.assert_allclose(xo.numpy(), np.asarray(s), atol=1e-5)
    np.testing.assert_allclose(ho.numpy(), np.asarray(
        _dense_norm(s, _j(g), _j(b), kind)), atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,d,widths", SHAPES)
def test_norm_linear_plain_vs_dense(kind, m, d, widths):
    """Three matrices read side by side equal one concatenated panel."""
    x, _, g, b, ws = _data(m, d, widths, kind)
    want = np.asarray(_dense_norm(jnp.asarray(x), _j(g), _j(b), kind)
                      @ jnp.concatenate([jnp.asarray(w) for w in ws], 1))
    got = T_norm.fused_norm_linear(_t(x), _t(g), _t(b),
                                   [_t(w) for w in ws], kind=kind, eps=EPS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    one = T_norm.fused_norm_linear(_t(x), _t(g), _t(b),
                                   [torch.from_numpy(np.concatenate(ws, 1))],
                                   kind=kind, eps=EPS)
    np.testing.assert_allclose(one.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("mode", ["silu", "gelu"])
@pytest.mark.parametrize("m,k,f", [(64, 128, 256), (5, 72, 130)])
def test_glu_plain_vs_reference(mode, m, k, f):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wg = (rng.normal(size=(k, f)) / k ** 0.5).astype(np.float32)
    wu = (rng.normal(size=(k, f)) / k ** 0.5).astype(np.float32)
    got = T_ffn.fused_glu(_t(x), _t(wg), _t(wu), mode=mode)
    want = J_ffn._glu_reference(jnp.asarray(x), jnp.asarray(wg),
                                jnp.asarray(wu), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        T_ffn._glu_reference(_t(x), _t(wg), _t(wu), mode).numpy(),
        np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------- one interpret-mode case per reference kernel ----------

def test_plain_versions_vs_pallas_interpret_tiny():
    """Rows 14, 15 and 12 of the kernel table: the reference's Pallas
    kernels (interpret mode) against the port's plain versions."""
    x, r, g, b, ws = _data(9, 40, (24, 8, 8), "layer", seed=5)
    jx, jg, jb = map(jnp.asarray, (x, g, b))
    xo, ho = J_norm.fused_residual_norm(jx, jnp.asarray(r), jg, jb,
                                        kind="layer", eps=EPS,
                                        interpret=True, bm=8)
    txo, tho = T_norm.fused_residual_norm(_t(x), _t(r), _t(g), _t(b),
                                          kind="layer", eps=EPS)
    np.testing.assert_allclose(txo.numpy(), np.asarray(xo), atol=1e-5)
    np.testing.assert_allclose(tho.numpy(), np.asarray(ho), atol=1e-5)
    wcat = np.concatenate(ws, 1)
    o = J_norm.fused_norm_linear(jx, jg, None, jnp.asarray(wcat),
                                 kind="rms", eps=EPS, interpret=True, bm=8,
                                 bf=128)
    to = T_norm.fused_norm_linear(_t(x), _t(g), None, [_t(w) for w in ws],
                                  kind="rms", eps=EPS)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-5)
    y = J_ffn.fused_glu_pallas(jx, jnp.asarray(ws[0]), jnp.asarray(ws[0]),
                               mode="gelu", interpret=True)
    ty = T_ffn.fused_glu(_t(x), _t(ws[0]), _t(ws[0]), mode="gelu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=2e-5,
                               rtol=2e-5)


def test_fusable_act_table_pinned_per_entry():
    """The port's fused mlp (the fused GLU's plain version) against the
    reference's dense mlp, for every _FUSABLE_ACT entry at the
    reference's per-entry pin."""
    tol = {"gelu_tanh": 2e-6, "gelu_via_softmax": 1e-6,
           "silu": 1e-6, "silu_via_softmax": 1e-6}
    assert T_layers._FUSABLE_ACT == J_layers._FUSABLE_ACT
    assert set(tol) == set(T_layers._FUSABLE_ACT)
    x = np.random.default_rng(6).normal(size=(2, 6, 64)).astype(np.float32)
    p = J_layers.mlp_init(jax.random.PRNGKey(2), 64, 128, jnp.float32,
                          gated=True)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    for act in T_layers._FUSABLE_ACT:
        dense = J_layers.mlp(p, jnp.asarray(x), act, impl="dense")
        fused = T_layers.mlp(tp, torch.from_numpy(x), act,
                             impl="fused_pallas")
        err = float(np.abs(fused.numpy() - np.asarray(dense)).max())
        assert err <= tol[act], (act, err)


def test_dualmode_activation_stays_dense_under_fused_impl():
    """silu_dualmode is not fusable: the fused impl runs the unit's
    words, as the dense path does."""
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 64)).astype(np.float32))
    p = T_layers.mlp_init(torch.Generator().manual_seed(0), 64, 96,
                          torch.device("cpu"))
    fused = T_layers.mlp(p, x, "silu_dualmode", impl="fused_pallas")
    assert torch.equal(fused, T_layers.mlp(p, x, "silu_dualmode",
                                           impl="dense"))


# ---------------- registries ----------------

def test_ffn_and_norm_registries(monkeypatch):
    for resolve in (dispatch.resolve_ffn, dispatch.resolve_norm):
        assert resolve("auto", "cpu") == "dense"
        assert resolve("fused_pallas", "cpu") == "fused_pallas"
        assert resolve("dense", "cpu") == "dense"
        with pytest.raises(ValueError):
            resolve("fused_triton", "cpu")
    monkeypatch.setattr(dispatch, "resolve_device", torch.device)
    assert dispatch.resolve_ffn("auto", "cuda") == "fused_pallas"
    assert dispatch.resolve_norm("auto", "cuda") == "fused_pallas"
    monkeypatch.undo()
    for get in (dispatch.get_ffn, dispatch.get_norm):
        assert get("dense") is None
        with pytest.raises(ValueError):
            get("auto")
        with pytest.raises(ValueError):
            get("bogus")
    prov = dispatch.get_norm("fused_pallas")
    assert set(prov) == set(dispatch.NORM_SEAMS)
    # the norm -> gated-GLU seam (row 16) computes its plain version's
    # result for CPU tensors
    x, _, g, _, ws = _data(5, 16, (12, 12), "rms", seed=8)
    got = prov["norm_glu"](_t(x), _t(g), None, _t(ws[0]), _t(ws[1]),
                           kind="rms", eps=EPS, mode="silu")
    assert torch.equal(got, T_norm.fused_norm_glu_plain(
        _t(x), _t(g), None, _t(ws[0]), _t(ws[1]), kind="rms", eps=EPS,
        mode="silu"))
    with pytest.raises(ValueError):
        dispatch.register_norm("partial", {"residual_norm": print})
    assert dispatch.get_ffn("fused_pallas") is not None


def test_matmul_tile_policy():
    """The tiles the wrappers hand the GEMM kernels, all on the pipelined
    body: the (bm, bn, copy width) and K split of the fused GLU and its
    backward (csrc/glu.cu, csrc/glu_bwd.cu: the gated-GLU bands) at rows
    12 / 13's shapes -- yi-6b's tick and chunk, llama-3.2-vision's
    bucket-4096 prefill, qwen1.5-0.5b's training step -- and those of
    csrc/norm_linear.cu, with its K splits at yi-6b's and bert-base's
    QKV."""
    from repro_torch.kernels import tiling

    def glu(m, k, f):
        return tiling.norm_gemm_plan(m, k, (f,), glu=True)
    assert glu(4, 4096, 11008) == ("decode", 16, 128, 3, 4)  # 86 strips x 3
    assert glu(64, 4096, 11008) == ("chunk", 64, 64, 3, 4)   # 172 tiles x 3
    assert glu(4096, 4096, 14336) == ("prefill", 128, 64, 1, 4)
    assert glu(8192, 1024, 2816) == ("prefill", 128, 64, 1, 4)  # 64 x 44
    assert tiling.norm_gemm_plan(4096, 4096, (14336,), glu=True,
                                 aligned=False) == ("prefill", 64, 64, 1, 1)
    yi = (4096, 512, 512)
    norm = {m: tiling.norm_gemm_plan(m, 4096, yi)
            for m in (1, 4, 16, 17, 64, 65, 127, 128, 512, 4096)}
    assert {(p.bm, p.bn, p.vec) for p in norm.values()} <= {
        (128, 128, 4), (64, 128, 4), (16, 256, 4)}
    assert norm[4] == ("decode", 16, 256, 13, 4)     # 20 strips x 13 splits
    assert norm[64] == ("chunk", 64, 128, 6, 4)      # 40 tiles x 6 splits
    assert norm[4096] == ("prefill", 128, 128, 1, 4)
    assert tiling.norm_gemm_plan(4096, 768, (768,) * 3) == (
        "prefill", 128, 128, 1, 4)                   # bert-base
    for m in (1, 64, 4096):                          # 4-byte copies
        p = tiling.norm_gemm_plan(m, 200, (130, 17, 40))
        assert (p.bm, p.bn, p.vec) == (64, 128, 1)
    assert all(p.bm >= min(m, 64) or p.band == "decode"
               for m, p in norm.items())


_PLAN_BAND = {1: "decode", 4: "decode", 16: "decode", 17: "chunk",
              64: "chunk", 65: "chunk", 127: "chunk", 128: "prefill",
              129: "prefill", 512: "prefill", 4096: "prefill"}


@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("k,widths", [
    (4096, (4096, 512, 512)), (4096, (14336,)), (768, (768, 768, 768)),
    (33, (64, 64)), (72, (5,)), (200, (130, 17, 40)), (64, (4, 6))])
def test_norm_gemm_plan_bands_and_copy_width(glu, k, widths):
    """tiling.norm_gemm_plan: the band follows M, the tile the band; the
    4-byte copy path (on the middle tile) whenever K, a width or a pointer
    is not a multiple of four floats, 16-byte copies otherwise; K is split
    into as many ranges as fill the resident-block slots in one wave, each
    range keeping its minimum of chunks; a gated-GLU chunk takes the split
    of the fewest waves per unit of depth instead, up to its cap."""
    from repro_torch.kernels import tiling
    if glu:
        widths = widths[:1]
    tiles = tiling.NORM_GEMM_TILES[glu]
    chunks = tiling.cdiv(k, tiling.NORM_GEMM_BK)
    for m, band in _PLAN_BAND.items():
        for aligned in (True, False):
            p = tiling.norm_gemm_plan(m, k, widths, glu=glu,
                                      aligned=aligned)
            four = aligned and k % 4 == 0 and all(n % 4 == 0
                                                  for n in widths)
            assert p.vec == (4 if four else 1)
            assert p.band == band
            assert (p.bm, p.bn) == tiles[band if four else "chunk"]
            blocks = tiling.cdiv(m, p.bm) * sum(tiling.cdiv(n, p.bn)
                                                for n in widths)
            slots, least = (tiling.NORM_GEMM_SLOTS,
                            tiling.NORM_GEMM_MIN_CHUNKS)
            assert p.split >= 1
            assert p.split == 1 or chunks >= p.split * least
            if glu and band == "chunk":
                most = min(chunks // least, tiling.NORM_GEMM_CHUNK_SPLITS)
                assert p.split <= max(1, most)

                def waves(s):
                    return tiling.cdiv(blocks * s, slots) / s
                assert all(waves(p.split) < waves(s)
                           for s in range(1, p.split))
                assert all(waves(p.split) <= waves(s)
                           for s in range(p.split, most + 1))
                continue
            assert p.split == 1 or blocks * p.split <= slots
            # one more range would spill into a second wave or starve
            assert (blocks * (p.split + 1) > slots
                    or chunks < (p.split + 1) * least)


def test_wrappers_refuse_unknown_kind_and_mode():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        T_norm.fused_residual_norm(x, x, torch.ones(8), kind="batch",
                                   eps=EPS)
    with pytest.raises(ValueError):
        T_norm.fused_norm_linear(x, torch.ones(8), None, [], kind="rms",
                                 eps=EPS)
    with pytest.raises(ValueError):
        T_ffn.fused_glu(x, torch.zeros(8, 3), torch.zeros(8, 3), mode="relu")


# ---------------- reduced yi-6b ----------------

def _pair(sm, act, seed=0):
    jcfg = J_registry.reduced_config("yi-6b").replace(softmax_impl=sm,
                                                      activation=act)
    tcfg = T_registry.reduced_config("yi-6b").replace(softmax_impl=sm,
                                                      activation=act, **FUSED)
    jp = J_tf.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def test_yi_params_convert_without_bias():
    jcfg, tcfg, jp, tp = _pair("float", "silu")
    own = init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa
    assert shapes(own) == shapes(tp)
    mixer = tp["layers"][0]["mixer"]
    assert all("b" not in mixer[w] for w in ("wq", "wk", "wv", "wo"))
    assert mixer["wk"]["w"].shape == (64, 2 * 16)        # 2 kv heads, h 16
    assert len(tp["layers"]) == jcfg.n_layers


def _count_seams(monkeypatch) -> dict:
    """Count the calls of every fused seam the model makes."""
    calls: dict = {}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped
    prov = dispatch.get_norm("fused_pallas")
    monkeypatch.setitem(dispatch._NORM, "fused_pallas", {
        k: counted(k, fn) for k, fn in prov.items()})
    monkeypatch.setitem(dispatch._FFN, "fused_pallas", counted(
        "glu", dispatch.get_ffn("fused_pallas")))
    return calls


@pytest.mark.parametrize("path", list(CONFIGS))
def test_yi_lm_apply_fused_matches_reference(path, monkeypatch):
    """The port's fused seams (plain versions) against the reference's
    dense forward on the same weights, full causal and then a paged
    chunk + one decode step through the paged split-KV path."""
    sm, act, tol = CONFIGS[path]
    jcfg, tcfg, jp, tp = _pair(sm, act)
    calls = _count_seams(monkeypatch)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 24))
    jl, _, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32))
    tl, _ = lm_apply(tp, tcfg, torch.from_numpy(toks), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    # every layer ran both norm seams; the GLU only for a fusable act
    want = {"residual_norm": 2, "norm_linear": 2}
    if path == "float":
        want["glu"] = 2
    assert calls == want

    tables = np.array([[3, 1, 0, 0]], np.int32)
    jc = J_tf.init_paged_caches(jcfg, 5, 8)
    from repro_torch.models.transformer import init_paged_caches
    tc = init_paged_caches(tcfg, 5, 8, device="cpu")
    chunk, last = toks[:1, :12], np.array([11])
    jl, jc, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(chunk, jnp.int32), pos=0,
                              caches=jc, last_pos=jnp.asarray(last),
                              paged=jnp.asarray(tables))
    tl, tc = lm_apply(tp, tcfg, torch.from_numpy(chunk), pos=0, caches=tc,
                      last_pos=torch.from_numpy(last),
                      paged=torch.from_numpy(tables), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    step, pos = np.array([[7]]), np.array([12], np.int32)
    jl, _, _ = J_tf.lm_apply(jp, jcfg.replace(attn_impl="flash_decode"),
                             jnp.asarray(step, jnp.int32),
                             pos=jnp.asarray(pos), caches=jc,
                             paged=jnp.asarray(tables))
    tl, _ = lm_apply(tp, tcfg.replace(attn_impl="flash_decode"),
                     torch.from_numpy(step), pos=torch.from_numpy(pos),
                     caches=tc, paged=torch.from_numpy(tables), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


def test_biased_qkv_keeps_the_dense_norm_under_fused_impls(monkeypatch):
    """qwen1.5-0.5b has a QKV bias: under the fused impls its norm1 stays
    dense (no norm -> QKV seam) while the residual-norm epilogue and the
    GLU run fused; logits still match the reference's dense forward."""
    jcfg = J_registry.reduced_config("qwen1.5-0.5b")
    tcfg = T_registry.reduced_config("qwen1.5-0.5b").replace(**FUSED)
    jp = J_tf.init_lm(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    calls = _count_seams(monkeypatch)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab, (2, 10))
    jl, _, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32))
    tl, _ = lm_apply(tp, tcfg, torch.from_numpy(toks), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert calls == {"residual_norm": 2, "glu": 2}


def test_yi_paged_engine_fused_streams_identical_to_reference():
    """The port's paged engine with the fused impls against the JAX
    engine with dense impls: identical greedy float token streams."""
    jcfg, tcfg, jp, tp = _pair("float", "silu")
    kw = dict(n_slots=2, max_seq=64, prefill_chunk=8)
    reqs = [(0, [1, 2, 3, 4, 5], 5), (1, list(range(7, 30)), 6),
            (2, [4] * 10, 4), (3, [2, 3], 3)]
    je = JEngine(jcfg, jp, **kw)
    te = ServeEngine(tcfg, tp, device="cpu", **kw)
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in reqs])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in reqs])
    assert to == jo
    assert te.pool.in_use() == 0 and te.stats["numeric"] == 0
