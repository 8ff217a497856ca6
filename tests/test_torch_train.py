"""The port's training path against the JAX reference: the datapath's
gradient homes, the plain backwards of the flash and fused-GLU kernels
(against ``jax.vjp`` of the reference's oracles), the autograd Functions
around every kernel of the path (against ``torch.autograd`` of the dense
graph), one train step on reduced qwen (against the reference's jitted
step on the same converted weights and the same numpy batch), and the
optimizer, data, checkpoint and launcher modules.

Each test draws its inputs from its own seeded ``np.random.RandomState``.
Tolerances are the reference's own: 1e-5 for the datapath and the
attention gradients (tests/test_flash_attention_bwd.py), 2e-5 for the
GLU gradients (tests/test_fused_ffn.py, its grad test), ce rtol 1e-5,
grad_norm rtol 1e-4 and new parameters 2e-5 for a train step
(tests/test_train.py), loss rtol 1e-4 across a checkpoint restart.  The CUDA kernels are held to these plain
versions by tests/test_torch_gpu.py and chip_smoke.py on the card.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.configs.base import TrainConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import datapath as J_dp
from repro.kernels import fused_ffn as J_ffn
from repro.kernels.flash_attention import flash_attention_pallas as j_fap
from repro.models import transformer as J_tf
from repro.models.attention import _naive_sdpa as j_naive
from repro.models.flash import flash_attention as j_flash
from repro.optim import adamw_init as j_adamw_init
from repro.optim import compress_decompress as j_compress
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import CheckpointStore, latest_step
from repro_torch.configs import registry as T_registry
from repro_torch.data import SyntheticLM
from repro_torch.kernels import datapath as T_dp
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as T_fa
from repro_torch.kernels import flash_attention_bwd as T_fb
from repro_torch.kernels import fused_ffn as T_ffn
from repro_torch.kernels import fused_norm as T_norm
from repro_torch.models.attention import _naive_sdpa as t_naive
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_caches, init_lm, lm_apply
from repro_torch.optim import (adamw_init, compress_decompress,
                               ef_state_init)
from repro_torch.serve import ServeEngine
from repro_torch.train import Trainer, TrainState, make_train_step
from repro_torch.tree import tree_leaves

EPS = 1e-6
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


GLU_ATOL = 2e-5


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------- the datapath's gradient homes ----------------

@pytest.mark.parametrize("mode", ["silu", "gelu"])
def test_pair_act_grad_vs_reference(mode):
    z = np.random.RandomState(0).randn(4096).astype(np.float32) * 4
    _close(T_dp.pair_act_grad(_t(z), mode),
           J_dp.pair_act_grad(jnp.asarray(z), mode), 1e-5)


def test_norm_vjps_vs_reference():
    rs = np.random.RandomState(1)
    x, dy = (rs.randn(6, 40).astype(np.float32) * 2 for _ in range(2))
    g = (1.0 + 0.1 * rs.randn(40)).astype(np.float32)
    for got, want in zip(T_dp.rmsnorm_vjp(_t(x), _t(g), EPS, _t(dy)),
                         J_dp.rmsnorm_vjp(x, g, EPS, dy)):
        _close(got, want, 1e-5)
    for got, want in zip(T_dp.layernorm_vjp(_t(x), _t(g), EPS, _t(dy)),
                         J_dp.layernorm_vjp(x, g, EPS, dy)):
        _close(got, want, 1e-5)


# ---------------- plain backwards vs jax.vjp of the oracles -------------

# (b, s, t, kh, g, h, hv, causal, block_kv, case): GQA, ragged kv_valid,
# S != T non-divisible, hv != h, non-causal, a row whose visible keys are
# all masked
ATTN = [(2, 33, 70, 2, 3, 16, 8, True, 16, "ragged"),
        (1, 40, 40, 2, 2, 16, 16, False, 64, "ragged"),
        (2, 20, 50, 1, 2, 8, 8, True, 16, "all_masked"),
        (1, 24, 24, 1, 4, 8, 8, True, 64, "full")]


def _attn_case(seed, b, s, t, kh, g, h, hv, case):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, s, kh, g, h) * h ** -0.5).astype(np.float32)
    k = rs.randn(b, t, kh, h).astype(np.float32)
    v = rs.randn(b, t, kh, hv).astype(np.float32)
    do = rs.randn(b, s, kh, g, hv).astype(np.float32)
    qp = np.broadcast_to(np.arange(t - s, t, dtype=np.int32), (b, s))
    valid = np.ones((b, t), bool)
    if case == "ragged":
        valid = rs.rand(b, t) > 0.25
    if case == "all_masked":        # row 0 sees only key 0, invalid
        qp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        valid[:, 0] = False
    return q, k, v, do, np.ascontiguousarray(qp), valid


def _port_saved(q, k, v, qp, valid, causal, bkv):
    args = (_t(q), _t(k), _t(v), _t(qp), _t(valid.astype(np.uint8)))
    o, m, l = T_fa.flash_fwd_plain(*args, causal=causal, block_kv=bkv,
                                   return_stats=True)
    return args, o, m, l


@pytest.mark.parametrize("b,s,t,kh,g,h,hv,causal,bkv,case", ATTN)
def test_flash_plain_backward_vs_jax_vjp(b, s, t, kh, g, h, hv, causal, bkv,
                                         case):
    q, k, v, do, qp, valid = _attn_case(7, b, s, t, kh, g, h, hv, case)
    (tq, tk, tv, tqp, tvalid), o, m, l = _port_saved(q, k, v, qp, valid,
                                                     causal, bkv)
    dq, dk, dv = T_fb.flash_attention_bwd_pallas(
        tq, tk, tv, o, m, l, _t(do), q_pos=tqp, kv_valid=tvalid,
        causal=causal, block_kv=bkv)
    kw = dict(q_pos=jnp.asarray(qp), kv_valid=jnp.asarray(valid),
              causal=causal, scale=1.0)
    for oracle in (lambda q_, k_, v_: j_flash(q_, k_, v_, block=bkv, **kw),
                   lambda q_, k_, v_: j_naive(q_, k_, v_, **kw)):
        _, vjp = jax.vjp(oracle, *map(jnp.asarray, (q, k, v)))
        for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
            _close(got, want, 1e-5)


@pytest.mark.parametrize("mode", ["silu", "gelu"])
def test_glu_plain_backward_vs_jax_vjp(mode):
    """d_gate / d_up against the vjp of pair_act(g) * u, and the whole
    Function's (dx, dWg, dWu) against the vjp of ``_glu_reference``."""
    rs = np.random.RandomState(2)
    m, k, f = 37, 48, 70
    x = rs.randn(m, k).astype(np.float32)
    wg, wu = ((rs.randn(k, f) / k ** 0.5).astype(np.float32)
              for _ in range(2))
    dy = rs.randn(m, f).astype(np.float32)
    g, u = x @ wg, x @ wu
    _, vjp = jax.vjp(lambda g_, u_: J_dp.pair_act(g_, mode) * u_,
                     jnp.asarray(g), jnp.asarray(u))
    for got, want in zip(T_ffn._glu_bwd_plain(_t(x), _t(wg), _t(wu), _t(dy),
                                              mode), vjp(jnp.asarray(dy))):
        _close(got, want, GLU_ATOL)
    tx, twg, twu = (_t(a).requires_grad_(True) for a in (x, wg, wu))
    y = T_ffn.fused_glu(tx, twg, twu, mode=mode)
    got = torch.autograd.grad(y, (tx, twg, twu), _t(dy))
    _, vjp = jax.vjp(lambda *a: J_ffn._glu_reference(*a, mode),
                     *map(jnp.asarray, (x, wg, wu)))
    for a, b in zip(got, vjp(jnp.asarray(dy))):
        _close(a, b, GLU_ATOL)


# ---------------- one interpret-mode case per reference kernel ----------

def test_autograd_vs_pallas_interpret_tiny():
    """Rows 10 / 11 (flash_attention_pallas) and 13 (fused_glu_pallas)
    under jax.grad against the port's autograd Functions."""
    q, k, v, do, qp, valid = _attn_case(3, 1, 24, 40, 1, 2, 8, 8, "ragged")

    def j_loss(q_, k_, v_):
        o = j_fap(q_, k_, v_, q_pos=jnp.asarray(qp),
                  kv_valid=jnp.asarray(valid), causal=True, scale=1.0,
                  block_q=8, block_kv=16, interpret=True)
        return jnp.sum(o * jnp.asarray(do))
    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = T_fa.flash_attention_pallas(tq, tk, tv, q_pos=_t(qp),
                                    kv_valid=_t(valid), causal=True,
                                    scale=1.0, block_kv=16)
    got = torch.autograd.grad((o * _t(do)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)

    rs = np.random.RandomState(4)
    x = rs.randn(9, 16).astype(np.float32)
    wg, wu = ((rs.randn(16, 24) / 4).astype(np.float32) for _ in range(2))
    dy = rs.randn(9, 24).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(J_ffn.fused_glu_pallas(
        *a, mode="gelu", interpret=True, bm=8, bf=128) * dy),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, wg, wu)))
    tx, twg, twu = (_t(a).requires_grad_(True) for a in (x, wg, wu))
    got = torch.autograd.grad(
        (T_ffn.fused_glu(tx, twg, twu, mode="gelu") * _t(dy)).sum(),
        (tx, twg, twu))
    for a, b in zip(got, want):
        _close(a, b, GLU_ATOL)


# ---------------- the Functions vs torch.autograd of the dense graph -----

def test_flash_function_vs_dense_autograd():
    q, k, v, do, qp, valid = _attn_case(5, 2, 33, 70, 2, 3, 16, 8, "ragged")
    outs = []
    for fn in (T_fa.flash_attention_pallas, t_naive):
        tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
        o = fn(tq, tk, tv, q_pos=_t(qp), kv_valid=_t(valid), causal=True,
               scale=0.7)
        outs.append((o,) + torch.autograd.grad(o, (tq, tk, tv), _t(do)))
    for a, b in zip(*outs):
        _close(a.detach(), b.detach(), 1e-5)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_functions_vs_dense_autograd(kind):
    rs = np.random.RandomState(6)
    x, r = (rs.randn(3, 5, 24).astype(np.float32) for _ in range(2))
    g = (1.0 + 0.1 * rs.randn(24)).astype(np.float32)
    b = (0.1 * rs.randn(24)).astype(np.float32) if kind == "layer" else None
    ws = [rs.randn(24, n).astype(np.float32) / 5 for n in (16, 8, 8)]
    d1, d2 = (rs.randn(3, 5, 24).astype(np.float32) for _ in range(2))
    d3 = rs.randn(3, 5, 32).astype(np.float32)

    def run(fused):
        tx, tr, tg = (_t(a).requires_grad_(True) for a in (x, r, g))
        tb = None if b is None else _t(b).requires_grad_(True)
        tws = [_t(w).requires_grad_(True) for w in ws]
        if fused:
            xo, ho = T_norm.fused_residual_norm(tx, tr, tg, tb, kind=kind,
                                                eps=EPS)
            o = T_norm.fused_norm_linear(tx, tg, tb, tws, kind=kind, eps=EPS)
        else:
            xo = tx + tr
            ho = T_norm._scaled(xo, tg, tb, kind=kind, eps=EPS)
            o = T_norm._scaled(tx, tg, tb, kind=kind, eps=EPS) @ torch.cat(
                tws, 1)
        loss = (xo * _t(d1)).sum() + (ho * _t(d2)).sum() + (o * _t(d3)).sum()
        ins = [tx, tr, tg] + ([] if tb is None else [tb]) + tws
        return torch.autograd.grad(loss, ins)
    for a, c in zip(run(True), run(False)):
        _close(a, c, 1e-5)


def test_forward_only_impls_refuse_grad():
    """The grad flag of the registry: the int and decode paths are
    forward-only, and asking them for a gradient raises."""
    assert dispatch.attention_grad("flash_pallas")
    assert dispatch.attention_grad("naive") and dispatch.attention_grad("flash")
    assert not dispatch.attention_grad("flash_pallas_int")
    assert not dispatch.attention_grad("flash_decode")
    from repro_torch.models.attention import _sdpa
    q = torch.randn(1, 4, 1, 1, 8, requires_grad=True)
    k = v = torch.randn(1, 4, 1, 8)
    with pytest.raises(ValueError, match="forward-only"):
        _sdpa(q, k, v, q_pos=torch.arange(4)[None], kv_valid=torch.ones(
            1, 4, dtype=torch.bool), softmax_impl="dualmode",
            attn_impl="flash_pallas_int")


def test_flash_return_stats_refuses_grad():
    """``return_stats`` is the forward-only form of the blocked kernel:
    with an input that requires grad it raises, and under no_grad it
    returns the statistics."""
    rs = np.random.RandomState(12)
    q = _t(rs.randn(1, 4, 1, 1, 8).astype(np.float32)).requires_grad_()
    k, v = (_t(rs.randn(1, 4, 1, 8).astype(np.float32)) for _ in range(2))
    kw = dict(q_pos=torch.arange(4, dtype=torch.int32)[None],
              kv_valid=torch.ones(1, 4, dtype=torch.bool), return_stats=True)
    with pytest.raises(ValueError, match="forward-only"):
        T_fa.flash_attention_pallas(q, k, v, **kw)
    with torch.no_grad():
        o, m, l = T_fa.flash_attention_pallas(q, k, v, **kw)
    assert o.shape == (1, 4, 1, 1, 8) and m.shape == l.shape == (1, 1, 1, 4)


# ---------------- serving builds no graph ----------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-6b"])
def test_serving_saves_nothing_for_backward(arch):
    """The Functions wrap kernels the serve paths call: with weights that
    do not require grad, prefill and decode logits carry no graph."""
    cfg = T_registry.reduced_config(arch).replace(
        norm_impl="fused_pallas", ffn_impl="fused_pallas",
        attn_impl="flash_pallas")
    params = init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.randint(0, cfg.vocab, (1, 24), generator=torch.Generator()
                         .manual_seed(1))
    logits, _ = lm_apply(params, cfg, toks,
                         caches=init_caches(cfg, 1, 32, CPU), device=CPU)
    assert logits.grad_fn is None
    eng = ServeEngine(cfg.replace(attn_impl="auto"), params, n_slots=1,
                      max_seq=64, device=CPU)
    eng.pool.alloc(1)
    tables = torch.tensor([[1] + [0] * (eng.max_blocks - 1)],
                          dtype=torch.int32)
    chunk = eng.prefill_chunk_logits(toks[:, :8], 0, tables,
                                     torch.tensor([7]))
    dec = eng.decode_logits(torch.argmax(chunk, -1)[:, None],
                            torch.tensor([8], dtype=torch.int32), tables)
    assert chunk.grad_fn is None and dec.grad_fn is None


# ---------------- one train step vs the reference's ----------------

SEQ, BATCH = 80, 4          # 80 keys: a 64-key tile and a ragged one


def _qwen(registry=T_registry):
    return registry.reduced_config("qwen1.5-0.5b").replace(vocab=96)


@pytest.fixture(scope="module")
def step_case():
    j_cfg = _qwen(J_registry)
    params = J_tf.init_lm(jax.random.PRNGKey(0), j_cfg)
    rs = np.random.RandomState(8)
    toks = rs.randint(0, j_cfg.vocab, size=(BATCH, SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, remat=True)
    state = JTrainState(params, j_adamw_init(params), {})
    np_params = jax.tree.map(np.asarray, params)
    return j_cfg, tcfg, state, np_params, batch


def _port_step(cfg, tcfg, np_params, batch):
    params = params_from_numpy(np_params, cfg, device=CPU)
    state = TrainState(params, adamw_init(params), {})
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    return make_train_step(cfg, tcfg, CPU)(state, tb)


def _jax_step(cfg, tcfg, state, batch):
    new, m = jax.jit(j_make_train_step(cfg, tcfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return params_from_numpy(jax.tree.map(np.asarray, new.params), _qwen(),
                             device=CPU), m


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_vs_reference(step_case, fused):
    """Dense impls on both sides; then the port's 'flash_pallas' with the
    fused norm / ffn Functions against the reference's 'flash' (dense
    norm and ffn)."""
    cfg, tcfg, state, np_params, batch = step_case
    t_cfg = _qwen().replace(attn_impl="flash_pallas",
                            norm_impl="fused_pallas",
                            ffn_impl="fused_pallas") if fused else _qwen()
    j_cfg = cfg.replace(attn_impl="flash") if fused else cfg
    s_t, m_t = _port_step(t_cfg, tcfg, np_params, batch)
    p_j, m_j = _jax_step(j_cfg, tcfg, state, batch)
    np.testing.assert_allclose(float(m_t["ce"]), float(m_j["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-4)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(s_t.params), tree_leaves(p_j)))
    assert diff < 2e-5, diff


def test_dualmode_train_step_vs_reference(step_case):
    """softmax_impl='dualmode' (naive: the unit's quantized scores cut wq
    and wk out of the graph, so their gradients are zero on both sides)
    against the reference's jitted step: ce and the gradient norm."""
    cfg, tcfg, state, np_params, batch = step_case
    s_t, m_t = _port_step(_qwen().replace(softmax_impl="dualmode"), tcfg,
                          np_params, batch)
    p_j, m_j = _jax_step(cfg.replace(softmax_impl="dualmode"), tcfg, state,
                         batch)
    np.testing.assert_allclose(float(m_t["ce"]), float(m_j["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-4)


def test_silu_dualmode_gradients_vs_reference(step_case):
    """The STE activation through the unit: each gradient tensor within
    1e-3 of its own max of the reference's (an S5.10 gate word that
    flips between XLA's and PyTorch's f32 orders moves the gradients),
    as chip_smoke.py holds the kernels' step to the plain one.  The
    float 2e-5 limit on updated parameters does not apply: the first
    AdamW step is sign-like and turns a small gradient difference on a
    near-zero entry into up to 2 lr."""
    from repro.train.step import make_loss_fn as j_make_loss_fn
    from repro_torch.train import make_grad_fn
    from repro_torch.tree import tree_paths
    cfg, tcfg, state, np_params, batch = step_case
    j_cfg = cfg.replace(activation="silu_dualmode")
    (_, (ce_j, _)), g_j = jax.jit(jax.value_and_grad(
        j_make_loss_fn(j_cfg, tcfg), has_aux=True))(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()})
    t_cfg = _qwen().replace(activation="silu_dualmode")
    params = params_from_numpy(np_params, t_cfg, device=CPU)
    (_, (ce_t, _)), g_t = make_grad_fn(t_cfg, tcfg, CPU)(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(ce_t), float(ce_j), rtol=1e-5)
    g_j = params_from_numpy(jax.tree.map(np.asarray, g_j), t_cfg, device=CPU)
    for (path, gt), gj in zip(tree_paths(g_t), tree_leaves(g_j)):
        scale = float(gj.abs().max())
        assert float((gt - gj).abs().max()) <= 1e-3 * scale, path


def test_adamw_update_vs_reference():
    """One AdamW update on one flat tree (decay on the 2-D leaf only,
    clipping by the global norm) and the schedule, against the
    reference's."""
    from repro.optim import adamw_update as j_update
    from repro.optim import wsd_schedule as j_wsd
    from repro_torch.optim import adamw_update, wsd_schedule
    rs = np.random.RandomState(11)
    p = {"w": rs.randn(5, 7), "b": rs.randn(7), "g": 1 + rs.randn(7) / 10}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    jp, jm = {k: jnp.asarray(v) for k, v in p.items()}, j_adamw_init(p)
    tp = {k: _t(v) for k, v in p.items()}
    tm = adamw_init(tp)
    for step in range(3):
        lr = wsd_schedule(step, lr=1e-2, warmup=2, total=10)
        np.testing.assert_allclose(lr, float(j_wsd(
            jnp.int32(step), lr=1e-2, warmup=2, total=10)), rtol=1e-6)
        jp, jm, jmet = j_update(g, jm, jp, lr=lr, grad_clip=0.5)
        tp, tm, tmet = adamw_update({k: _t(v) for k, v in g.items()}, tm, tp,
                                    lr=lr, grad_clip=0.5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        for tree_t, tree_j in ((tp, jp), (tm.m, jm.m), (tm.v, jm.v)):
            for k in p:
                _close(tree_t[k], tree_j[k], 1e-6)
    assert tm.step == 3


def test_microbatch_equals_full_batch(step_case):
    _, _, _, np_params, batch = step_case
    cfg = _qwen()
    t_full = TrainConfig(lr=1e-3, microbatch=0, remat=False)
    t_micro = TrainConfig(lr=1e-3, microbatch=2, remat=False)
    s1, m1 = _port_step(cfg, t_full, np_params, batch)
    s2, m2 = _port_step(cfg, t_micro, np_params, batch)
    np.testing.assert_allclose(float(m1["ce"]), float(m2["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-4)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert diff < 2e-5, diff


# ---------------- trainer, checkpoint, data, optimizer, launcher --------

def _tcfg(ck, every, **kw):
    return TrainConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                       checkpoint_every=every, checkpoint_dir=str(ck), **kw)


def test_checkpoint_restart_continues_exactly(tmp_path):
    cfg = _qwen()
    kw = dict(global_batch=4, seq_len=16, device=CPU, log=lambda *_: None)
    Trainer(cfg, _tcfg(tmp_path / "ck", 3), **kw).run(3)    # saves at 3
    resumed = Trainer(cfg, _tcfg(tmp_path / "ck", 3), **kw)
    assert resumed.start_step == 3
    m_res = resumed.run(3)
    m_cont = Trainer(cfg, _tcfg(tmp_path / "ck2", 1000), **kw).run(6)
    np.testing.assert_allclose(m_res["loss"], m_cont["loss"], rtol=1e-4)


def test_trainer_refuses_what_needs_a_mesh(tmp_path):
    cfg = _qwen()
    with pytest.raises(NotImplementedError):
        Trainer(cfg, _tcfg(tmp_path, 10, fsdp=True), 4, 16, device=CPU)
    with pytest.raises(NotImplementedError):
        Trainer.from_checkpoint(cfg, _tcfg(tmp_path, 10), 4, 16, mesh=None)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, _tcfg(tmp_path, 10), 4, 16, device=CPU, mesh=object())


def test_checkpoint_store_roundtrip_incomplete_and_gc(tmp_path):
    rs = np.random.RandomState(9)
    tree = TrainState({"w": [_t(rs.randn(3, 2).astype(np.float32))]},
                      adamw_init({"w": [torch.zeros(3, 2)]}), {})
    store = CheckpointStore(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        store.save(step, tree._replace(opt=tree.opt._replace(step=step)),
                   block=False)
    store.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    os.makedirs(tmp_path / "step_9.tmp")         # a save that never finished
    os.makedirs(tmp_path / "step_8")             # no manifest
    assert latest_step(str(tmp_path)) == 3
    got, step, _ = store.restore(tree)
    assert step == 3 and got.opt.step == 3
    assert torch.equal(got.params["w"][0], tree.params["w"][0])


def test_bigram_stream():
    """The table is the reference's; batch(step) is pure and its labels
    are the next tokens."""
    mine = SyntheticLM(vocab=96, seq_len=32, global_batch=4, seed=3)
    ref = JSyntheticLM(vocab=96, seq_len=32, global_batch=4, seed=3)
    np.testing.assert_array_equal(mine._tbl.numpy(), np.asarray(ref._tbl))
    t0, l0 = mine.batch(5)
    t1, l1 = mine.batch(5)
    assert torch.equal(t0, t1) and torch.equal(l0, l1)
    assert not torch.equal(mine.batch(6)[0], t0)
    assert torch.equal(t0[:, 1:], l0[:, :-1])
    assert t0.shape == (4, 32) and int(t0.max()) < 96


def test_grad_compress_carries_residual():
    rs = np.random.RandomState(10)
    g = {"a": rs.randn(5, 7).astype(np.float32),
         "b": [rs.randn(11).astype(np.float32) * 1e-3]}
    e = {"a": rs.randn(5, 7).astype(np.float32) * 1e-2,
         "b": [np.zeros(11, np.float32)]}
    tg = {"a": _t(g["a"]), "b": [_t(g["b"][0])]}
    te = {"a": _t(e["a"]), "b": [_t(e["b"][0])]}
    c, e2 = compress_decompress(tg, te)
    jc, je2 = j_compress(g, e)
    for got, want in zip(tree_leaves(c) + tree_leaves(e2),
                         jax.tree.leaves(jc) + jax.tree.leaves(je2)):
        _close(got, want, 1e-6)
    for ci, ei, gi, eo in zip(tree_leaves(c), tree_leaves(e2),
                              tree_leaves(tg), tree_leaves(te)):
        _close(ci + ei, gi + eo, 1e-6)
    assert all(torch.equal(z, torch.zeros_like(z))
               for z in tree_leaves(ef_state_init(tg)))


def test_launch_train_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", "16",
        "--ckpt", str(tmp_path / "ck")])
    train.main()
    assert "[train] done" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "ck")) == 3
