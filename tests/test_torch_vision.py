"""The port's llama-3.2-vision slice against the JAX reference on the same
weights and inputs: the norm -> gated-GLU seam (row 16's plain version,
which the wrapper runs for CPU tensors, and its autograd backward), the
cross attention (``cross_kv`` / ``cross_apply``), reduced
llama-3.2-vision through ``lm_apply`` with image embeddings, prefill then
decode over the cross caches, the contiguous engine with and without
``cross_src``, the engine's cache-mode rule, the serve launcher, and the
refusal to train the vlm family.

Every ``cross_gate`` is set to 0.5 in the numpy tree both packages load:
the reference's init leaves it at 0, and tanh(0) would take the cross
sublayer out of the logits, so a broken cross path would pass.

Tolerances.  The norm -> gated-GLU seam at the reference's own f32 limits
(tests/test_fused_norm.py: outputs 1e-5, gradients 2e-5).  Model logits:
float 1e-5 (f32 orders).  Dual-mode: every block given the reference's
input stays within 2e-3 of the reference's block (a flipped score or
SiLU word moves one output by up to ~1e-3: measured 9.9e-4 over 8
seeds), and the logits within 5e-3, bert-base's limit
(tests/test_torch_bert.py), because the reduced model carries such a
flip through its later layers into the logits (measured 4.7e-5 to
2.26e-3 over 8 seeds; the flips come from the self-attention blocks, the
cross block stays at ~1e-6).  Float greedy token streams identical.
"""
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.kernels import datapath as J_dp
from repro.kernels import fused_norm as J_norm
from repro.models import attention as J_attn
from repro.models import transformer as J_tf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_norm as T_norm
from repro_torch.models import attention as T_attn
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ARCH = "llama-3.2-vision-11b"
EPS = 1e-6
GATE = 0.5
CROSS_LAYER = 3          # the period's cross-attention position
# (m, d, f): even tiles, and everything ragged
SHAPES = [(64, 128, 256), (23, 72, 120)]
CONFIGS = {"float dense": (dict(), 1e-5),
           "float fused": (dict(norm_impl="fused_pallas",
                                ffn_impl="fused_pallas"), 1e-5),
           "dualmode": (dict(softmax_impl="dualmode",
                             activation="silu_dualmode",
                             norm_impl="fused_pallas"), 5e-3)}
TOL_DUAL_BLOCK = 2e-3


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _glu_data(m, d, f, kind, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    b = ((0.1 * rng.normal(size=(d,))).astype(np.float32)
         if kind == "layer" else None)
    wg = (rng.normal(size=(d, f)) / d ** 0.5).astype(np.float32)
    wu = (rng.normal(size=(d, f)) / d ** 0.5).astype(np.float32)
    dy = rng.normal(size=(m, f)).astype(np.float32)
    return x, g, b, wg, wu, dy


def _dense_oracle(kind, mode):
    """The reference's dense norm -> GLU graph (tests/test_fused_norm.py)."""
    def fn(x, g, b, wg, wu):
        h = (J_dp.rmsnorm(x, g, EPS) if kind == "rms"
             else J_dp.layernorm(x, g, b, EPS))
        return J_dp.pair_act(h @ wg, mode) * (h @ wu)
    return fn


def _port_grads(x, g, b, wg, wu, dy, kind, mode):
    ins = [_t(a).clone().requires_grad_(True) for a in (x, g, wg, wu)]
    bt = None if b is None else _t(b).clone().requires_grad_(True)
    y = T_norm.fused_norm_glu(ins[0], ins[1], bt, ins[2], ins[3], kind=kind,
                              eps=EPS, mode=mode)
    leaves = ins[:2] + ([bt] if bt is not None else []) + ins[2:]
    return y, torch.autograd.grad(y, leaves, _t(dy))


# ---------------- row 16: the norm -> gated-GLU seam ----------------

@pytest.mark.parametrize("mode", ["silu", "gelu"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("m,d,f", SHAPES)
def test_norm_glu_plain_vs_dense_oracle(kind, mode, m, d, f):
    """Outputs and gradients (x, g, b, wg, wu) against the reference's
    dense graph and jax.grad of it."""
    x, g, b, wg, wu, dy = _glu_data(m, d, f, kind, seed=m + d)
    dense = _dense_oracle(kind, mode)
    y, grads = _port_grads(x, g, b, wg, wu, dy, kind, mode)
    jargs = [jnp.asarray(a) for a in (x, g, b if b is not None else g, wg,
                                      wu)]
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(dense(*jargs)), atol=1e-5)
    argnums = (0, 1, 2, 3, 4) if kind == "layer" else (0, 1, 3, 4)
    want = jax.grad(lambda *a: jnp.vdot(dense(*a), jnp.asarray(dy)),
                    argnums=argnums)(*jargs)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-5)


def test_norm_glu_plain_and_backward_vs_pallas_interpret_tiny():
    """Row 16 itself: the reference's Pallas kernel (interpret mode) and
    jax.vjp through its custom VJP (the GLU backward kernel, row 13)
    against the port's plain version and autograd backward."""
    x, g, b, wg, wu, dy = _glu_data(9, 40, 70, "layer", seed=5)

    def ref(*a):
        return J_norm.fused_norm_glu(*a, kind="layer", eps=EPS, mode="gelu",
                                     interpret=True, bm=8, bf=128)
    out, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (x, g, b, wg, wu)))
    y, grads = _port_grads(x, g, b, wg, wu, dy, "layer", "gelu")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    for got, w in zip(grads, vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-5)


def test_norm_glu_keeps_leading_axes_and_refuses_unknown_mode():
    x, g, _, wg, wu, _ = _glu_data(6, 16, 24, "rms", seed=1)
    x3 = _t(x).reshape(2, 3, 16)
    y = T_norm.fused_norm_glu(x3, _t(g), None, _t(wg), _t(wu), kind="rms",
                              eps=EPS, mode="silu")
    assert tuple(y.shape) == (2, 3, 24)
    torch.testing.assert_close(y.reshape(6, 24), T_norm.fused_norm_glu_plain(
        _t(x), _t(g), None, _t(wg), _t(wu), kind="rms", eps=EPS,
        mode="silu"), atol=0, rtol=0)
    with pytest.raises(ValueError):
        T_norm.fused_norm_glu(_t(x), _t(g), None, _t(wg), _t(wu),
                              kind="rms", eps=EPS, mode="relu")


def test_matmul_tile_policy_of_norm_glu():
    """The norm -> gated-GLU kernel's (bm, bn, copy width) triples: the
    ones csrc/norm_glu.cu instantiates (bn columns of each of Wg and Wu),
    and its K splits at the vision path's rows (d 4096, F 14336)."""
    from repro_torch.kernels import tiling
    plans = {m: tiling.norm_gemm_plan(m, 4096, (14336,), glu=True)
             for m in (1, 4, 16, 17, 32, 33, 64, 512, 4096)}
    assert {(p.bm, p.bn, p.vec) for p in plans.values()} <= {
        (128, 64, 4), (64, 64, 4), (16, 128, 4)}
    assert plans[4] == ("decode", 16, 128, 2, 4)     # 112 strips x 2 splits
    assert plans[512] == ("prefill", 128, 64, 1, 4)
    assert plans[4096] == ("prefill", 128, 64, 1, 4)
    p = tiling.norm_gemm_plan(67, 72, (14336,), glu=True, aligned=False)
    assert (p.bm, p.bn, p.vec) == (64, 64, 1)


# ---------------- cross attention ----------------

@pytest.mark.parametrize("sm,impl", [("float", "naive"), ("float", "flash"),
                                     ("dualmode", "naive")])
def test_cross_kv_and_cross_apply_vs_reference(sm, impl):
    jcfg = J_registry.reduced_config(ARCH).replace(softmax_impl=sm,
                                                   attn_impl=impl)
    tcfg = T_registry.reduced_config(ARCH).replace(softmax_impl=sm,
                                                   attn_impl=impl)
    jp = jax.tree.map(np.asarray, J_attn.cross_init(
        jax.random.PRNGKey(3), J_tf.attn_spec(jcfg, causal=False),
        jnp.float32))
    tp = jax.tree.map(_t, jp)
    rs = np.random.RandomState(2)
    enc = rs.normal(size=(2, 40, jcfg.d_model)).astype(np.float32)
    x = rs.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    js, ts = J_tf.attn_spec(jcfg, causal=False), T_tf.attn_spec(
        tcfg, causal=False)
    jkv = J_attn.cross_kv(jp, js, jnp.asarray(enc))
    tkv = T_attn.cross_kv(tp, ts, _t(enc))
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=1e-5)
    want = J_attn.cross_apply(jp, js, jnp.asarray(x), jkv)
    got = T_attn.cross_apply(tp, ts, _t(x), tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 if sm == "float" else 2e-3)


# ---------------- reduced llama-3.2-vision ----------------

def _pair(over=None, seed=0, **cfg_over):
    jcfg = J_registry.reduced_config(ARCH).replace(**(over or {}),
                                                   **cfg_over)
    tcfg = T_registry.reduced_config(ARCH).replace(**(over or {}),
                                                   **cfg_over)
    jp = jax.tree.map(np.asarray, J_tf.init_lm(jax.random.PRNGKey(seed),
                                               jcfg))
    layer = jp["periods"][CROSS_LAYER]
    layer["cross_gate"] = np.full_like(layer["cross_gate"], GATE)
    tp = params_from_numpy(jp, tcfg, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def _inputs(cfg, seed, b=2, s=12):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, (b, s))
    img = rs.normal(size=(b, cfg.n_img_tokens, cfg.d_model)).astype(
        np.float32)
    return toks, img


def test_cross_gate_reaches_the_logits():
    """With the gate at 0.5 the image embeddings move the logits (at the
    reference's zero gate they would not)."""
    _, tcfg, _, tp = _pair()
    toks, img = _inputs(tcfg, 0)
    a = T_tf.lm_apply(tp, tcfg, _t(toks), cross_src=_t(img), device="cpu")[0]
    b = T_tf.lm_apply(tp, tcfg, _t(toks), cross_src=_t(0 * img),
                      device="cpu")[0]
    assert float((a - b).abs().max()) > 0.1
    assert float(tp["layers"][CROSS_LAYER]["cross_gate"]) == GATE
    assert tp["layers"][CROSS_LAYER]["cross_gate"].ndim == 0


def test_params_and_caches_follow_the_reference_layout():
    jcfg, tcfg, _, tp = _pair()
    specs = T_tf.layer_specs(tcfg)
    assert [s.cross for s in specs] == [False, False, False, True, False]
    assert set(tp["layers"][CROSS_LAYER]) == {
        "norm1", "cross_norm", "cross", "cross_gate", "norm2", "ffn"}
    assert set(tp["layers"][0]) == {"norm1", "mixer", "norm2", "ffn"}
    init = T_tf.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert float(init["layers"][CROSS_LAYER]["cross_gate"]) == 0.0
    assert jax.tree.map(np.shape, jax.tree.map(
        np.asarray, init["layers"])) == jax.tree.map(np.shape, tp["layers"])
    caches = T_tf.init_caches(tcfg, 3, 20, device="cpu")
    jc = J_tf.init_caches(jcfg, 3, 20)
    for i, (c, spec) in enumerate(zip(caches, specs)):
        assert set(c) == set(jc["periods"][i])
        for key, pair in c.items():
            for x in pair.values():
                assert tuple(x.shape) == jc["periods"][i][key]["k"].shape[1:]
                assert not x.any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reduced_vision_logits_vs_reference(name, monkeypatch):
    over, tol = CONFIGS[name]
    jcfg, tcfg, jp, tp = _pair(over)
    toks, img = _inputs(jcfg, 0)
    calls = []
    prov = dispatch.get_norm("fused_pallas")
    seam = prov["norm_glu"]
    monkeypatch.setitem(prov, "norm_glu",
                        lambda *a, **k: calls.append(1) or seam(*a, **k))
    jl, _, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks),
                             cross_src=jnp.asarray(img))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(toks), cross_src=_t(img),
                          device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    # the seam fires once a cross layer, only with a fusable activation
    fires = (over.get("norm_impl") == "fused_pallas"
             and over.get("activation", "silu") == "silu")
    assert len(calls) == (tcfg.n_layers // len(tcfg.pattern) if fires else 0)


def test_dualmode_blocks_track_reference():
    """Each block of the dual-mode model, given the reference's input,
    against the reference's block (see the module docstring)."""
    jcfg, tcfg, jp, tp = _pair(CONFIGS["dualmode"][0])
    toks, img = _inputs(jcfg, 0)
    pos = np.broadcast_to(np.arange(toks.shape[1])[None], toks.shape)
    ctx = J_tf.Ctx(positions=jnp.asarray(pos), pos=0,
                   cross_src=jnp.asarray(img))
    x = jp["embed"][jnp.asarray(toks)]
    for j, spec in enumerate(jcfg.pattern):
        bp = jax.tree.map(lambda a: a[0], jp["periods"][j])
        want, _, _ = J_tf.block_apply(bp, jcfg, spec, x, {}, ctx)
        got, _, _ = T_tf.block_apply(tp["layers"][j], tcfg, spec,
                                     _t(np.asarray(x)), None,
                                     positions=_t(pos.copy()), pos=0,
                                     paged=None, cross_src=_t(img))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_DUAL_BLOCK, err_msg=f"block {j}")
        x = want


@pytest.mark.parametrize("sm,act,tol", [("float", "silu", 1e-5),
                                        ("dualmode", "silu_dualmode", 5e-3)])
def test_prefill_then_decode_over_cross_caches(sm, act, tol):
    """1100 image tokens, so that one decode row against the cross keys
    resolves to the split-KV kernel's path ('flash_decode', non-causal):
    prefill with the embeddings into the caches, then a ragged decode
    step reading the cross K/V from them, against the reference with its
    own caches; float also against the port's own full forward."""
    over = dict(softmax_impl=sm, activation=act)
    jcfg, tcfg, jp, tp = _pair(over, n_img_tokens=1100)
    assert dispatch.resolve_attention("auto", 1, 1100, sm,
                                      device="cpu") == "flash_decode"
    toks, img = _inputs(jcfg, 1, s=10)
    lens = np.array([10, 7], np.int32)
    jc = J_tf.init_caches(jcfg, 2, 24)
    tc = T_tf.init_caches(tcfg, 2, 24, device="cpu")
    jl, jc, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks), pos=0, caches=jc,
                              cross_src=jnp.asarray(img),
                              last_pos=jnp.asarray(lens - 1))
    tl, tc = T_tf.lm_apply(tp, tcfg, _t(toks), pos=0, caches=tc,
                           cross_src=_t(img), last_pos=_t(lens - 1),
                           device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    np.testing.assert_allclose(
        tc[CROSS_LAYER]["cross_kv"]["k"].numpy(),
        np.asarray(jc["periods"][CROSS_LAYER]["cross_kv"]["k"][0]),
        atol=1e-5)
    step = np.array([[5], [11]])
    jd, _, _ = J_tf.lm_apply(jp, jcfg, jnp.asarray(step),
                             pos=jnp.asarray(lens), caches=jc)
    td, _ = T_tf.lm_apply(tp, tcfg, _t(step), pos=_t(lens), caches=tc,
                          device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=tol)
    if sm == "float":
        full = np.concatenate([toks[:1], step[:1]], axis=1)
        fl, _ = T_tf.lm_apply(tp, tcfg, _t(full), cross_src=_t(img[:1]),
                              device="cpu")
        np.testing.assert_allclose(td[0, -1].numpy(), fl[0, -1].numpy(),
                                   atol=1e-5)


# ---------------- the contiguous engine ----------------

REQ_LENS = ((0, 5, 4, True), (1, 19, 3, True), (2, 3, 5, False),
            (3, 11, 2, True))


def _requests(cfg, cls, array):
    rs = np.random.RandomState(7)
    reqs = []
    for rid, n, new, with_img in REQ_LENS:
        prompt = rs.randint(0, cfg.vocab, size=n).tolist()
        img = rs.normal(size=(1, cfg.n_img_tokens, cfg.d_model)).astype(
            np.float32)
        reqs.append(cls(rid=rid, prompt=prompt, max_new=new,
                        cross_src=array(img) if with_img else None))
    return reqs


@pytest.mark.parametrize("max_seq", [64, 1024])
def test_contiguous_engine_streams_identical_to_reference(max_seq):
    """Three requests with image embeddings and one without, 2 slots;
    'auto' picks the contiguous cache on both sides."""
    jcfg, tcfg, jp, tp = _pair()
    kw = dict(n_slots=2, max_seq=max_seq, prefill_buckets=(16, 32))
    je = JEngine(jcfg, jp, **kw)
    te = ServeEngine(tcfg, tp, device="cpu", **kw)
    assert je.cache_mode == te.cache_mode == "contiguous"
    assert te.decode_attn_impl == je.decode_attn_impl
    jo = je.run(_requests(jcfg, JRequest, jnp.asarray))
    to = te.run(_requests(tcfg, Request, torch.from_numpy))
    assert to == jo
    assert te.stats["cache_copies"] == len(REQ_LENS)
    assert te.stats["numeric"] == 0 and te.active == 0


def test_engine_cache_mode_rule():
    _, tcfg, _, tp = _pair()
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tp, cache_mode="paged", device="cpu")
    assert ServeEngine(tcfg, tp, device="cpu").cache_mode == "contiguous"
    qcfg = T_registry.reduced_config("qwen1.5-0.5b")
    qp = T_tf.init_lm(qcfg, torch.Generator().manual_seed(0), "cpu")
    assert ServeEngine(qcfg, qp, device="cpu").cache_mode == "paged"
    with pytest.raises(ValueError):
        T_tf.init_paged_caches(tcfg, 4, 8, device="cpu")


def test_serve_launcher_runs_the_vision_arch(capsys):
    from repro_torch.launch import serve
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "2", "--max-seq", "64"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert "cache=contiguous" in out and "2 requests" in out


def test_training_refuses_the_vlm_family():
    from repro_torch.launch import train as train_launch
    from repro_torch.train import Trainer, make_train_step
    tcfg = T_registry.reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="vlm"):
        make_train_step(tcfg, TrainConfig(), "cpu")
    with pytest.raises(NotImplementedError, match="vlm"):
        Trainer(tcfg, TrainConfig(), 2, 8, device="cpu")
    argv = ["train", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--steps", "1"]
    with mock.patch.object(sys, "argv", argv), \
            pytest.raises(NotImplementedError, match="vlm"):
        train_launch.main()
