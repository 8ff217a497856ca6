"""The port's Mamba slice (jamba-v0.1-52b) against the JAX reference on
the same weights and inputs: ``mamba_apply`` (outputs, conv and SSM
states, from zeros and from a nonzero state, with prompts shorter than
the conv window), reduced jamba through ``lm_apply`` float (dense and
with the fused seams) and dual-mode (the unit's softmax in its attention
layer, its SiLU mode in the MLP and MoE FFNs), prefill then decode
against the reference's caches and against the full pass, the contiguous
engine against the JAX engine on tests/test_serve.py's requests, the
cache-mode rule, the selective scan's plain version at split lengths,
and the serve launcher's depth cut.

Tolerances: ``mamba_apply`` outputs and states 1e-5; float logits 1e-5 of
max(1, max |reference|) (XLA's and PyTorch's f32 orders, as in
tests/test_torch_rwkv.py: up to 1.4e-5 at logits of ~4.3 over three
seeds); dual-mode blocks 2e-3 given the reference's input
(tests/test_torch_model.py's limit: a score or SiLU word within an ulp
of an S5.10 boundary can round to its neighbour; measured up to 3.1e-4
over four seeds) and dual-mode logits 5e-3, qwen3's limit in
tests/test_torch_mla.py: a flipped word carries through the later
blocks, the Mamba states included, into logits of ~4 (measured 1e-3 to
4e-3 over three seeds); prefill then decode against the full pass at the
reference's own 2e-4.  The plain scan split in two equals the whole bit
for bit.  Greedy engine streams identical.
"""
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models import mamba as J_mamba
from repro.models import transformer as J_tf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.kernels import recurrence as rec
from repro_torch.models import mamba as T_mamba
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ARCH = "jamba-v0.1-52b"
CPU = torch.device("cpu")
REQS = [(0, [1, 2, 3, 4, 5], 5), (1, [7, 8, 9], 7), (2, [4] * 10, 4),
        (3, [2, 3], 3)]
FUSED = dict(norm_impl="fused_pallas", ffn_impl="fused_pallas")
# name: (config overrides, logit limit (x max(1, max |ref|) for float))
MODES = {"float": ({}, 1e-5),
         "fused": (FUSED, 1e-5),
         "dualmode": (dict(softmax_impl="dualmode",
                           activation="silu_dualmode"), 5e-3)}

j_lm_apply = jax.jit(J_tf.lm_apply, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_tree(params, cfg):
    """The port's weights as numpy leaves in the reference's layout (each
    period's blocks stacked on a leading axis): the reference's jitted
    init_lm costs seconds of compile; its shapes are checked below."""
    n = len(cfg.pattern)
    tree = {k: jax.tree.map(lambda a: a.numpy(), v)
            for k, v in params.items() if k != "layers"}
    tree["periods"] = [jax.tree.map(
        lambda *xs: np.stack([x.numpy() for x in xs]),
        *params["layers"][j::n]) for j in range(n)]
    return tree


@pytest.fixture(scope="module")
def jamba():
    jcfg = J_registry.reduced_config(ARCH)
    tcfg = T_registry.reduced_config(ARCH)
    np_params = reference_tree(
        T_tf.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu"), tcfg)
    return jcfg, np_params, params_from_numpy(np_params, tcfg, device=CPU)


def _tokens(cfg, seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape)


def _logits_close(mine, ref, tol, scaled=True):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if scaled else 1.0
    np.testing.assert_allclose(mine.numpy(), ref, atol=tol * scale)


def _close(mine: dict, ref: dict, atol=1e-5):
    assert set(mine) == set(ref)
    for key in ref:
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, err_msg=key)


def test_jamba_params_and_state_follow_the_reference_layout(jamba):
    jcfg, np_params, tp = jamba
    tcfg = T_registry.reduced_config(ARCH)
    T_tf.check_supported(T_registry.get_config(ARCH))
    m = tcfg.mamba
    mixer = tp["layers"][0]["mixer"]
    assert tuple(mixer["A_log"].shape) == (m.d_inner, m.d_state)
    assert tuple(mixer["conv_w"].shape) == (m.d_conv, m.d_inner)
    assert [s.mixer for s in T_tf.layer_specs(tcfg)].count("attn") == 1
    ref = jax.eval_shape(lambda k: J_tf.init_lm(k, jcfg),
                         jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, np_params)
    torch.testing.assert_close(mixer["A_log"], torch.log(torch.arange(
        1.0, m.d_state + 1)).expand(m.d_inner, -1))
    mine = T_tf.init_caches(tcfg, 3, 20, device=CPU)
    ref = J_tf.init_caches(jcfg, 3, 20)["periods"]
    for i, layer in enumerate(mine):
        assert set(layer) == set(ref[i])
        for name, part in layer.items():
            for key, x in part.items():
                assert tuple(x.shape) == ref[i][name][key].shape[1:]


@pytest.mark.parametrize("sl,warm", [(1, True), (2, True), (9, False),
                                     (9, True)])
def test_mamba_apply_matches_reference(jamba, sl, warm):
    """From zeros or from a nonzero state; S 1 and 2 are shorter than the
    conv window's d_conv - 1 rows, so the new conv state keeps old rows."""
    _, np_params, tp = jamba
    spec = T_tf.mamba_spec(T_registry.reduced_config(ARCH))
    rs = np.random.RandomState(sl)
    x = rs.randn(2, sl, spec.d_model).astype(np.float32)
    st = None
    if warm:
        st = {"conv": rs.randn(2, spec.d_conv - 1, spec.d_inner),
              "ssm": rs.randn(2, spec.d_inner, spec.d_state) * 0.3}
        st = {k: v.astype(np.float32) for k, v in st.items()}
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["periods"][0]["mixer"])
    jo, js = J_mamba.mamba_apply(
        jp, J_mamba.MambaSpec(*spec), jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    to, ts = T_mamba.mamba_apply(
        tp["layers"][0]["mixer"], spec, _t(x),
        state=None if st is None else {k: _t(v) for k, v in st.items()})
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    _close(ts, js)


@pytest.mark.parametrize("mode", list(MODES))
def test_jamba_lm_apply_matches_reference(jamba, mode):
    over, tol = MODES[mode]
    jcfg, np_params, tp = jamba
    tcfg = T_registry.reduced_config(ARCH).replace(**over)
    toks = _tokens(jcfg)
    jl, _, _ = j_lm_apply(jax.tree.map(jnp.asarray, np_params),
                          jcfg.replace(**over), jnp.asarray(toks))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    _logits_close(tl, jl, tol, scaled=mode != "dualmode")


def test_jamba_dualmode_blocks_track_reference(jamba):
    """Each dual-mode block given the reference's input, against the
    reference's block (2e-3)."""
    jcfg, np_params, tp = jamba
    over = MODES["dualmode"][0]
    jcfg = jcfg.replace(**over)
    tcfg = T_registry.reduced_config(ARCH).replace(norm_impl="fused_pallas",
                                                   **over)
    jp = jax.tree.map(jnp.asarray, np_params)
    toks = _tokens(jcfg)
    pos = np.broadcast_to(np.arange(toks.shape[1])[None], toks.shape)

    @jax.jit
    def j_block(bp, x, spec):          # one compile for each distinct spec
        ctx = J_tf.Ctx(positions=jnp.asarray(pos), pos=0)
        return J_tf.block_apply(bp, jcfg, spec, x, {}, ctx)[0]
    j_block = jax.jit(j_block.__wrapped__, static_argnums=2)
    x = jp["embed"][jnp.asarray(toks)]
    for i in range(jcfg.n_layers):
        want = j_block(jax.tree.map(lambda a: a[0], jp["periods"][i]), x,
                       jcfg.pattern[i])
        got, _, _ = T_tf.block_apply(tp["layers"][i], tcfg, tcfg.pattern[i],
                                     _t(x), None, positions=_t(pos), pos=0,
                                     paged=None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                                   err_msg=f"block {i}")
        x = want


@pytest.mark.parametrize("mode", ["float", "dualmode"])
def test_jamba_prefill_then_decode_matches_reference_and_full(jamba, mode):
    """A 7-token prefill and a decode step against the reference's logits,
    KV rows and states; the step's logits against the 8-token pass."""
    over, tol = MODES[mode]
    jcfg, np_params, tp = jamba
    jcfg = jcfg.replace(**over)
    jp = jax.tree.map(jnp.asarray, np_params)
    tcfg = T_registry.reduced_config(ARCH).replace(**over)
    toks = _tokens(jcfg, 3, (2, 8))
    jc = J_tf.init_caches(jcfg, 2, 32)
    tc = T_tf.init_caches(tcfg, 2, 32, device=CPU)
    for sl, pos in ((slice(0, 7), 0), (slice(7, 8), 7)):
        jl, jc, _ = j_lm_apply(jp, jcfg, jnp.asarray(toks[:, sl]), pos=pos,
                               caches=jc)
        tl, tc = T_tf.lm_apply(tp, tcfg, _t(toks[:, sl]), pos=pos, caches=tc,
                               device=CPU)
        _logits_close(tl, jl, tol, scaled=mode == "float")
        if mode == "float":
            for i, layer in enumerate(tc):
                for name, part in layer.items():
                    _close(part, {k: v[0] for k, v in
                                  jc["periods"][i][name].items()})
    full, _ = T_tf.lm_apply(tp, tcfg, _t(toks), pos=0,
                            caches=T_tf.init_caches(tcfg, 2, 32, device=CPU),
                            device=CPU)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, -1].numpy(),
                               atol=2e-4)


def test_jamba_engine_streams_equal_reference(jamba):
    """3 slots, max_seq 48, buckets (8, 16), which the exact-length
    prefill ignores: greedy streams token for token, 4 prefills; the
    prefill's attention impl resolves at (max_seq, max_seq)."""
    jcfg, np_params, tp = jamba
    kw = dict(n_slots=3, max_seq=48, prefill_buckets=(8, 16))
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **kw)
    te = ServeEngine(T_registry.reduced_config(ARCH), tp, device=CPU, **kw)
    assert te.cache_mode == je.cache_mode == "contiguous"
    assert te.prefill_attn_impl == je.prefill_attn_impl
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    assert to == jo
    assert te.stats["prefills"] == je.stats["prefills"] == 4
    assert te.active == 0


def test_admission_overwrites_a_slots_state(jamba):
    """A slot's state drifts through the ticks it idles in; the next
    admission copies the new row's state over it, so a request served in
    a reused slot streams as in a fresh engine."""
    _, _, tp = jamba
    tcfg = T_registry.reduced_config(ARCH)
    kw = dict(n_slots=2, max_seq=48, device=CPU)
    eng = ServeEngine(tcfg, tp, **kw)
    eng.run([Request(rid=0, prompt=[3, 1, 4], max_new=2),
             Request(rid=1, prompt=[1, 5, 9, 2, 6], max_new=9)])
    late = eng.run([Request(rid=2, prompt=[5, 3, 5], max_new=6)])[2]
    fresh = ServeEngine(tcfg, tp, **kw).run(
        [Request(rid=2, prompt=[5, 3, 5], max_new=6)])[2]
    assert late == fresh


def test_jamba_paged_refused_auto_contiguous(jamba):
    _, _, tp = jamba
    tcfg = T_registry.reduced_config(ARCH)
    assert not T_tf.paged_supported(tcfg)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tp, n_slots=1, max_seq=16, cache_mode="paged",
                    device=CPU)
    eng = ServeEngine(tcfg, tp, n_slots=1, max_seq=16, device=CPU)
    assert eng.cache_mode == "contiguous"


@pytest.mark.parametrize("split", [1, 13, 31])
def test_selective_scan_plain_split_and_reference_scan(split):
    """The plain selective scan over 32 steps equals its first ``split``
    steps then the rest from the carried state, bit for bit; and it
    equals the reference's ``_ssm_scan`` within 1e-5."""
    rs = np.random.RandomState(split)
    b, sl, di, ds = 2, 32, 24, 8
    xc = rs.randn(b, sl, di).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, sl, di) - 2.0)).astype(np.float32)
    a_log = np.log(rs.uniform(0.5, 8.0, (di, ds))).astype(np.float32)
    bm, cm = (rs.randn(b, sl, ds).astype(np.float32) for _ in range(2))
    h0 = (rs.randn(b, di, ds) * 0.3).astype(np.float32)
    a = -torch.exp(_t(a_log))
    args = [_t(v) for v in (xc, dt)], [_t(v) for v in (bm, cm)]
    y, h = rec.selective_scan(*args[0], a, *args[1], _t(h0))
    cut = lambda ts, s: [t[:, s] for t in ts]          # noqa: E731
    y1, h1 = rec.selective_scan(*cut(args[0], slice(0, split)), a,
                                *cut(args[1], slice(0, split)), _t(h0))
    y2, h2 = rec.selective_scan(*cut(args[0], slice(split, None)), a,
                                *cut(args[1], slice(split, None)), h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)
    jh, jy = J_mamba._ssm_scan({"A_log": jnp.asarray(a_log)}, None,
                               *(jnp.asarray(v) for v in (xc, dt, bm, cm,
                                                          h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)


def test_serve_launcher_cuts_jamba_depth(capsys):
    from repro_torch.launch import serve
    argv = ["serve", "--arch", ARCH, "--reduced", "--layers", "8",
            "--device", "cpu", "--requests", "3", "--max-new", "3",
            "--max-seq", "64", "--norm-impl", "fused_pallas"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert "cache=contiguous" in out and "3 requests, 9 tokens" in out
