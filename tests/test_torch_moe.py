"""The port's mixture-of-experts slice against the JAX reference on the
same weights and inputs: ``models/moe.py`` (routing, the group-local sort
dispatch with its capacity drops, the dense oracle, shared and padded
experts, gradients, dual-mode experts), reduced granite-moe-3b-a800m
through ``lm_apply`` (full forward, contiguous and paged caches, the
fused seams, dual-mode block by block), the engine on the reference's
own settings (tests/test_serve.py), one train step with the load-balance
loss in the gradient, and the launchers.

Tolerances.  MoE outputs 1e-5 and the aux loss 1e-6 (f32 orders);
gradients of sum((y - tgt)**2) + 0.1 * aux at the reference's own 2e-4
(tests/test_moe.py); dual-mode experts 2e-3, the dual-mode limit of
tests/test_torch_model.py.  Float logits 1e-5.  Dual-mode blocks: 2e-3 on
the tokens whose expert sets agree.  A route flips where two f32 dot
orders move a token's k-th and (k+1)-th router probabilities past each
other, which a flipped dual-mode word makes likely: every dual-mode
comparison first counts the tokens whose expert sets differ and admits a
flip only where its margin (the gap between the k-th and (k+1)-th
probability) is at most twice the largest router-probability difference
on that layer's agreeing tokens.  One train step: ce and aux rtol 1e-5,
grad norm rtol 1e-4, new parameters 2e-5 (tests/test_train.py).
"""
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.configs.base import TrainConfig
from repro.models import moe as J_moe
from repro.models import transformer as J_tf
from repro.optim import adamw_init as j_adamw_init
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import registry as T_registry
from repro_torch.models import moe as T_moe
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves

ARCH = "granite-moe-3b-a800m"
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec(mod, **kw):
    base = dict(d_model=32, d_ff=64, n_experts=4, top_k=2, n_shared=0,
                capacity_factor=1.25, activation="silu", dispatch="sort")
    base.update(kw)
    return mod.MoESpec(**base)


def _x(b=2, s=8, d=32, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (b, s, d)) * 0.5)


# the reference's functions, jitted (a MoESpec and a config are static)
j_moe_apply = jax.jit(J_moe.moe_apply, static_argnums=1,
                      static_argnames="dropless")
j_route = jax.jit(J_moe._route, static_argnums=1)
j_lm_apply = jax.jit(J_tf.lm_apply, static_argnums=1)


def _pair(seed=1, **kw):
    js, ts = _spec(J_moe, **kw), _spec(T_moe, **kw)
    jp = J_moe.moe_init(jax.random.PRNGKey(seed), js, jnp.float32)
    return js, ts, jp, jax.tree.map(_t, jp)


# ---------------- moe_apply against the reference ----------------

CASES = {"sort dropless": (dict(), True),
         "capacity 1.25": (dict(), False),
         "capacity 0.25": (dict(capacity_factor=0.25), False),
         "dense oracle": (dict(dispatch="dense"), False),
         "shared expert": (dict(n_shared=1), True),
         "ep_pad 6": (dict(ep_pad=6), True)}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case):
    kw, dropless = CASES[case]
    js, ts, jp, tp = _pair(**kw)
    x = _x()
    yj, aj = j_moe_apply(jp, js, jnp.asarray(x), dropless=dropless)
    yt, at = T_moe.moe_apply(tp, ts, _t(x), dropless=dropless)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6)
    if kw.get("ep_pad"):
        assert tp["gate"].shape[0] == 6 and tp["router"].shape[1] == 4


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_capacity_drops_the_reference_slots(cf):
    """Routes, within-expert ranks and the dropped (t, k) slots equal the
    reference's (its stable argsort per group); 0.25 drops some."""
    js, ts, jp, tp = _pair(capacity_factor=cf)
    x = _x(b=3, s=16)
    gj, ij, _ = j_route(jp, js, jnp.asarray(x))
    gt, it, _ = T_moe._route(tp, ts, _t(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
    cap = T_moe.capacity(ts, 16, dropless=False)
    assert cap == min(int(np.ceil(16 * 2 / 4 * cf)), 16)
    rank_t = T_moe.slot_ranks(it, 4).numpy()
    for g in range(3):
        _, (gk, rank_j) = jax.jit(J_moe._moe_sort_local,
                                  static_argnums=(1, 5, 6))(
            jp, js, jnp.asarray(x[g]), gj[g], ij[g], cap, 4)
        np.testing.assert_array_equal(rank_t[g], np.asarray(rank_j))
        np.testing.assert_array_equal(rank_t[g] >= cap,
                                      np.asarray(gk) == 0)
    assert (rank_t >= cap).any() or cf > 1


def test_dense_oracle_holds_the_sort_path():
    """The port's own oracle against its sort path, dropless."""
    _, ts, _, tp = _pair(seed=5)
    x = _t(_x(seed=4))
    ys, auxs = T_moe.moe_apply(tp, ts, x, dropless=True)
    yd, auxd = T_moe.moe_apply(tp, ts._replace(dispatch="dense"), x)
    torch.testing.assert_close(ys, yd, atol=1e-5, rtol=0)
    assert float(auxs) == float(auxd)


def test_zero_router_ties_break_as_top_k():
    """All-equal probabilities: idx is lax.top_k's order (lower index
    first), and aux is within 0.2 of 1 (the reference's test)."""
    js, ts, jp, tp = _pair(seed=3, n_experts=8)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _x(b=4, s=16)
    _, ij, _ = j_route(jp, js, jnp.asarray(x))
    _, it, aux = T_moe._route(tp, ts, _t(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it.numpy() == np.arange(2)).all()
    _, aj = j_moe_apply(jp, js, jnp.asarray(x), dropless=True)
    _, at = T_moe.moe_apply(tp, ts, _t(x), dropless=True)
    assert abs(float(at) - 1.0) < 0.2
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6)


@pytest.mark.parametrize("dropless", [True, False])
def test_gradients_match_reference(dropless):
    """d/d(params, x) of sum((y - tgt)**2) + 0.1 * aux against jax.grad
    of the reference's sort path (capacity-bound when not dropless)."""
    js, ts, jp, tp = _pair(seed=7, capacity_factor=0.5)
    x = _x(seed=9)
    tgt = np.asarray(jax.random.normal(jax.random.PRNGKey(8), x.shape))

    def jloss(p_, x_):
        y, aux = J_moe.moe_apply(p_, js, x_, dropless=dropless)
        return jnp.sum((y - tgt) ** 2) + 0.1 * aux

    gj_p, gj_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp,
                                                          jnp.asarray(x))
    live = jax.tree.map(lambda a: a.clone().requires_grad_(True), tp)
    xt = _t(x).requires_grad_(True)
    y, aux = T_moe.moe_apply(live, ts, xt, dropless=dropless)
    loss = torch.sum((y - _t(tgt)) ** 2) + 0.1 * aux
    loss.backward()
    for k in tp:
        np.testing.assert_allclose(live[k].grad.numpy(), np.asarray(gj_p[k]),
                                   atol=2e-4, rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj_x), atol=2e-4,
                               rtol=2e-4)


def test_dualmode_experts_match_reference():
    """silu_dualmode experts: the unit's pair mode over the buffer."""
    js, ts, jp, tp = _pair(seed=11, activation="silu_dualmode")
    x = _x(seed=12)
    yj, _ = j_moe_apply(jp, js, jnp.asarray(x), dropless=True)
    yt, _ = T_moe.moe_apply(tp, ts, _t(x), dropless=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-3)


def test_padded_stacks_convert():
    """params_from_numpy carries the router and the padded stacks of a
    model whose ep_pad exceeds n_experts."""
    from repro.configs.base import MoECfg as JMoECfg
    from repro_torch.configs.base import MoECfg as TMoECfg
    jcfg = J_registry.reduced_config(ARCH).replace(
        moe=JMoECfg(n_experts=4, top_k=2, d_ff=64, ep_pad=6))
    tcfg = T_registry.reduced_config(ARCH).replace(
        moe=TMoECfg(n_experts=4, top_k=2, d_ff=64, ep_pad=6))
    jp = J_tf.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    for i, lp in enumerate(tp["layers"]):
        ffn = jp["periods"][0]["ffn"]
        assert lp["ffn"]["gate"].shape == (6, 64, 64)
        assert lp["ffn"]["router"].shape == (64, 4)
        for k in ("router", "gate", "up", "down"):
            np.testing.assert_array_equal(lp["ffn"][k].numpy(),
                                          np.asarray(ffn[k][i]))
    toks = np.random.RandomState(3).randint(0, jcfg.vocab, (2, 12))
    jl, _, ja = j_lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32))
    tl, _, ta = T_tf.lm_apply(tp, tcfg, _t(toks), return_aux=True,
                              device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


# ---------------- reduced granite through lm_apply ----------------

def _granite(seed=0, **over):
    jcfg = J_registry.reduced_config(ARCH).replace(**over)
    tcfg = T_registry.reduced_config(ARCH).replace(**over)
    jp = J_tf.init_lm(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, np_params


@pytest.fixture(scope="module")
def granite():
    return _granite()


@pytest.mark.parametrize("impls", ["dense", "fused"])
def test_lm_apply_full_forward_matches_reference(granite, impls):
    """Logits and the summed aux; 'fused' runs the port's residual-norm
    epilogue into the MoE (the plain versions of rows 14 / 15) against
    the reference's dense graph."""
    jcfg, tcfg, jp, np_params = granite
    if impls == "fused":
        tcfg = tcfg.replace(norm_impl="fused_pallas", ffn_impl="fused_pallas")
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 24))
    jl, _, ja = j_lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32))
    tl, caches = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    assert caches is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    _, _, ta = T_tf.lm_apply(tp, tcfg, _t(toks), return_aux=True,
                             device=CPU)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


def test_contiguous_prefill_and_decode_match_reference(granite):
    """A bucket-16 prefill of a 13-token prompt (pad tokens route too;
    dropless), then one decode step, from the same caches."""
    jcfg, tcfg, jp, np_params = granite
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, jcfg.vocab, (1, 16))
    toks[0, 13:] = 0
    last = np.array([12])
    jc = J_tf.init_caches(jcfg, 1, 32)
    tc = T_tf.init_caches(tcfg, 1, 32, device=CPU)
    jl, jc, _ = j_lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32), pos=0,
                           caches=jc, last_pos=jnp.asarray(last))
    tl, tc = T_tf.lm_apply(tp, tcfg, _t(toks), pos=0, caches=tc,
                           last_pos=_t(last), device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    step = np.array([[int(np.argmax(np.asarray(jl)[0, -1]))]])
    pos = np.array([13], np.int32)
    jl, _, _ = j_lm_apply(jp, jcfg, jnp.asarray(step, jnp.int32),
                          pos=jnp.asarray(pos), caches=jc)
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(step), pos=_t(pos), caches=tc,
                          device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def test_paged_chunk_and_decode_match_reference(granite):
    """A chunk through shuffled block tables, then a two-slot decode."""
    jcfg, tcfg, jp, np_params = granite
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    bs, n_pool = 8, 9
    tables = np.array([[3, 7, 1, 0], [2, 8, 5, 0]], np.int32)
    rs = np.random.RandomState(2)
    jc = J_tf.init_paged_caches(jcfg, n_pool, bs)
    tc = T_tf.init_paged_caches(tcfg, n_pool, bs, device=CPU)
    lens = [12, 9]
    for i in range(2):
        toks = rs.randint(0, jcfg.vocab, (1, 12))
        last = np.array([lens[i] - 1])
        jl, jc, _ = j_lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32),
                               pos=0, caches=jc,
                               last_pos=jnp.asarray(last),
                               paged=jnp.asarray(tables[i:i + 1]))
        tl, tc = T_tf.lm_apply(tp, tcfg, _t(toks), pos=0, caches=tc,
                               last_pos=_t(last),
                               paged=_t(tables[i:i + 1]), device=CPU)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    step, pos = np.array([[5], [11]]), np.array(lens, np.int32)
    jl, _, _ = j_lm_apply(jp, jcfg, jnp.asarray(step, jnp.int32),
                          pos=jnp.asarray(pos), caches=jc,
                          paged=jnp.asarray(tables))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(step), pos=_t(pos), caches=tc,
                          paged=_t(tables), device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def _spy_routes(module, store):
    """Wrap ``module._route`` to record each call's router input and
    expert ids."""
    inner = module._route

    def route(p, s, x):
        gates, idx, aux = inner(p, s, x)
        store.append((x, idx))
        return gates, idx, aux
    return mock.patch.object(module, "_route", route)


def _probs(x, router):
    logits = np.asarray(x, np.float64) @ np.asarray(router, np.float64)
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return z / z.sum(-1, keepdims=True)


def route_agreement(ref, got, router, k):
    """(agree mask (B,S), flip margins, largest router-probability
    difference on the agreeing tokens) of two (router input, idx)
    records."""
    (xr, ir), (xg, ig) = ref, got
    pr, pg = _probs(xr, router), _probs(xg, router)
    ir, ig = np.asarray(ir), np.asarray(ig)
    agree = (np.sort(ir, -1) == np.sort(ig, -1)).all(-1)
    srt = -np.sort(-pr, -1)
    gap = srt[..., k - 1] - srt[..., k]
    diff = float(np.abs(pr - pg)[agree].max()) if agree.any() else 0.0
    return agree, gap[~agree], diff


def test_dualmode_blocks_match_reference_on_agreeing_routes(granite):
    """Each block given the reference's block input: outputs within 2e-3
    on the tokens whose expert sets agree, every flip within the flip
    rule (the margins are logged)."""
    jcfg, tcfg, jp, np_params = granite
    over = dict(softmax_impl="dualmode", activation="silu_dualmode")
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab, (2, 24))
    pos = np.broadcast_to(np.arange(24)[None], toks.shape)
    ctx = J_tf.Ctx(positions=jnp.asarray(pos), pos=0)
    x = jp["embed"][jnp.asarray(toks)]
    spec = jcfg.pattern[0]
    k = jcfg.moe.top_k

    @jax.jit
    def ref_block(bp, x):
        jr = []
        with _spy_routes(J_moe, jr):
            out, _, _ = J_tf.block_apply(bp, jcfg, spec, x, {}, ctx)
        return out, jr[0]

    for i in range(jcfg.n_layers):
        bp = jax.tree.map(lambda a, i=i: a[i], jp["periods"][0])
        want, jr = ref_block(bp, x)
        tr = []
        with _spy_routes(T_moe, tr):
            got, _, _ = T_tf.block_apply(tp["layers"][i], tcfg, spec,
                                         _t(x), None, positions=_t(pos),
                                         pos=0, paged=None)
        agree, margins, diff = route_agreement(
            jr, [t.detach().numpy() for t in tr[0]], bp["ffn"]["router"], k)
        print(f"block {i}: {int((~agree).sum())} flips, margins "
              f"{margins.tolist()}, agreeing router diff {diff:.2e}")
        assert (margins <= 2 * diff).all(), (i, margins, diff)
        np.testing.assert_allclose(got.numpy()[agree],
                                   np.asarray(want)[agree], atol=2e-3,
                                   err_msg=f"block {i}")
        x = want


# ---------------- the engine and a train step ----------------

REQS = [(0, [1, 2, 3, 4, 5], 5), (1, [7, 8, 9], 7), (2, [4] * 10, 4),
        (3, [2, 3], 3)]


def _engines(granite, **kw):
    jcfg, tcfg, jp, np_params = granite
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    kw = dict(n_slots=3, max_seq=48, prefill_buckets=(8, 16), **kw)
    return JEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp, device=CPU, **kw)


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_engine_streams_equal_reference(granite, mode):
    """tests/test_serve.py's settings: 3 slots, max_seq 48, its four
    requests; greedy streams token for token."""
    je, te = _engines(granite, cache_mode=mode)
    assert te.cache_mode == je.cache_mode == mode
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    assert to == jo
    assert te.stats["prefills"] == je.stats["prefills"] == 4
    assert te.active == 0


def test_engine_under_a_tight_pool_equals_reference(granite):
    """A pool too small for the decode growth of three slots: both
    engines preempt (recompute), and every stream equals the reference's
    and the port's own ample run's."""
    reqs = [(0, [1] * 8, 12), (1, [2] * 8, 12), (2, [3] * 9, 10)]
    je, te = _engines(granite, num_blocks=6)
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in reqs])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in reqs])
    assert to == jo
    assert te.stats["preemptions"] == je.stats["preemptions"] >= 1
    assert te.pool.in_use() == 0
    _, ample = _engines(granite)
    assert ample.run([Request(rid=r, prompt=p, max_new=n)
                      for r, p, n in reqs]) == to


def test_train_step_matches_reference(granite):
    """One remat step, CE + 0.01 aux in the gradient, capacity-bound
    dispatch (train mode) on both sides."""
    jcfg, tcfg_t, jp, np_params = granite
    rs = np.random.RandomState(8)
    toks = rs.randint(0, jcfg.vocab, size=(2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, remat=True)
    state = JTrainState(jp, j_adamw_init(jp), {})
    new_j, m_j = jax.jit(j_make_train_step(jcfg, tcfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(np_params, tcfg_t, device=CPU)
    s_t, m_t = make_train_step(tcfg_t, tcfg, CPU)(
        TrainState(params, adamw_init(params), {}),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    for key in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=1e-5, err_msg=key)
    assert 1.5 < float(m_t["aux"]) < 2.5          # two layers, each ~1
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-4)
    p_j = params_from_numpy(jax.tree.map(np.asarray, new_j.params), tcfg_t,
                            device=CPU)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(s_t.params), tree_leaves(p_j)))
    assert diff < 2e-5, diff


def test_aux_weight_is_in_the_gradient(granite):
    """The router's gradient moves with the aux weight: the differentiated
    loss is ce + w * aux, and the reported loss is that value."""
    from repro_torch.train import make_grad_fn
    _, tcfg_t, _, np_params = granite
    params = params_from_numpy(np_params, tcfg_t, device=CPU)
    toks = np.random.RandomState(9).randint(0, tcfg_t.vocab, (2, 9))
    batch = {"tokens": _t(toks[:, :-1]).long(),
             "labels": _t(toks[:, 1:]).long()}
    tcfg = TrainConfig(remat=False)
    (l0, (ce0, aux0)), g0 = make_grad_fn(tcfg_t, tcfg, CPU, 0.0)(params,
                                                                  batch)
    (l1, (ce1, aux1)), g1 = make_grad_fn(tcfg_t, tcfg, CPU, 1.0)(params,
                                                                  batch)
    assert float(l0) == float(ce0) and float(ce0) == float(ce1)
    torch.testing.assert_close(l1, ce1 + aux1)
    r0 = g0["layers"][0]["ffn"]["router"]
    r1 = g1["layers"][0]["ffn"]["router"]
    assert float((r1 - r0).abs().max()) > 1e-4


def test_entry_points_accept_granite_and_refuse_the_rest():
    """init_lm / check_supported take granite (and, since the recurrent
    slice, a moe ffn under a mamba mixer, as jamba's; since the
    prefix-layer slice, a supported prefix layer and MoE under MLA, as
    deepseek-v2-lite's); MoE under an rwkv or 'none' mixer, a prefix of
    either, mamba layers without a mamba config and alibi still raise."""
    T_tf.check_supported(T_registry.get_config(ARCH))
    cfg = T_registry.reduced_config(ARCH)
    from repro_torch.configs.base import LayerSpec
    T_tf.check_supported(T_registry.get_config("jamba-v0.1-52b"))
    T_tf.check_supported(J_registry.get_config("deepseek-v2-lite-16b"))
    T_tf.check_supported(cfg.replace(prefix=(LayerSpec(),)))
    T_tf.check_supported(cfg.replace(
        pattern=(LayerSpec(mixer="mla", ffn="moe"),)))
    refused = [cfg.replace(prefix=(LayerSpec(mixer="rwkv", ffn="moe"),)),
               cfg.replace(prefix=(LayerSpec(mixer="mamba"),)),
               cfg.replace(pattern=(LayerSpec(mixer="mamba", ffn="moe"),)),
               cfg.replace(pattern=(LayerSpec(mixer="rwkv", ffn="moe"),)),
               cfg.replace(pattern=(LayerSpec(mixer="none", ffn="moe"),)),
               cfg.replace(pos_emb="alibi")]
    for bad in refused:
        with pytest.raises(NotImplementedError):
            T_tf.check_supported(bad)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_take_granite(launcher, tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve, train
    argv = {"serve": ["serve", "--arch", ARCH, "--reduced", "--device",
                      "cpu", "--max-seq", "32", "--requests", "2",
                      "--max-new", "3"],
            "train": ["train", "--arch", ARCH, "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                      "--layers", "1", "--ckpt", str(tmp_path / "ck")]}
    monkeypatch.setattr(sys, "argv", argv[launcher])
    {"serve": serve, "train": train}[launcher].main()
    out = capsys.readouterr().out
    assert (f"[serve] {ARCH}" if launcher == "serve" else "'aux'") in out
