"""The port's whisper-base slice against the JAX reference on the same
weights and inputs: the encoder stack (``encoder_apply``: sinusoid
positions, non-causal attention, GELU MLPs), reduced whisper-base through
``lm_apply`` with the encoder's output as ``cross_src``, prefill then
decode over the self and cross caches, and the contiguous engine (frames
through the encoder at admission) against the JAX engine.

Every ``cross_gate`` is set to 0.5 in the numpy tree both packages load:
the reference's init leaves it at 0, and tanh(0) would take the cross
sublayer, and with it the encoder, out of the logits.

Tolerances: float 1e-5 (f32 orders).  Dual-mode (the unit's softmax and
GELU modes) 5e-3, the bert / vision limit (tests/test_torch_bert.py): a
score or GELU word within an ulp of an S5.10 boundary can round to its
neighbour when XLA and PyTorch sum a dot in other orders, and the
reduced model carries such a flip into the outputs.  Prefill then decode
against the full pass at the reference's own 2e-4 (tests/
test_models.py).  Greedy engine streams identical.
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
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ARCH = "whisper-base"
CPU = torch.device("cpu")
GATE = 0.5
DUAL = dict(softmax_impl="dualmode", activation="gelu_dualmode")
TOL = {"float": 1e-5, "dualmode": 5e-3}

# the reference's functions, jitted (a config is static)
j_init_lm = jax.jit(J_tf.init_lm, static_argnums=1)
j_encoder = jax.jit(J_tf.encoder_apply, static_argnums=1)
j_lm_apply = jax.jit(J_tf.lm_apply, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def whisper():
    """(jax config, numpy params with the cross gates at 0.5, port
    params, frames (2, n_frames, d), tokens (2, 12)) of reduced
    whisper-base."""
    jcfg = J_registry.reduced_config(ARCH)
    np_params = jax.tree.map(np.asarray, j_init_lm(
        jax.random.PRNGKey(0), jcfg))
    gate = np_params["periods"][0]["cross_gate"]
    np_params["periods"][0]["cross_gate"] = np.full_like(gate, GATE)
    tp = params_from_numpy(np_params, T_registry.reduced_config(ARCH),
                           device=CPU)
    rs = np.random.RandomState(0)
    frames = rs.normal(size=(2, jcfg.n_frames, jcfg.d_model)).astype(
        np.float32)
    toks = rs.randint(0, jcfg.vocab, (2, 12))
    return jcfg, np_params, tp, frames, toks


@pytest.fixture(scope="module")
def reference(whisper):
    """The reference's encoder outputs and logits, each mode run once."""
    jcfg, np_params, _, frames, toks = whisper
    jp = jax.tree.map(jnp.asarray, np_params)
    out = {}
    for mode, over in (("float", {}), ("dualmode", DUAL)):
        cfg = jcfg.replace(**over)
        enc = j_encoder(jp, cfg, jnp.asarray(frames))
        logits, _, _ = j_lm_apply(jp, cfg, jnp.asarray(toks),
                                  cross_src=enc)
        out[mode] = (np.asarray(enc), np.asarray(logits))
    return out


def test_params_and_caches_follow_the_reference_layout(whisper):
    jcfg, np_params, tp, _, _ = whisper
    tcfg = T_registry.reduced_config(ARCH)
    T_tf.check_supported(T_registry.get_config(ARCH))
    assert len(tp["encoder"]["blocks"]) == jcfg.enc_layers
    assert set(tp["encoder"]) == {"blocks", "norm"}
    assert set(tp["encoder"]["blocks"][0]) == {"norm1", "mixer", "norm2",
                                               "ffn"}
    assert set(tp["layers"][0]) == {"norm1", "mixer", "cross_norm",
                                    "cross", "cross_gate", "norm2", "ffn"}
    init = T_tf.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(np.shape, jax.tree.map(np.asarray, init))
    assert shapes == jax.tree.map(np.shape, jax.tree.map(np.asarray, tp))
    caches = T_tf.init_caches(tcfg, 3, 20, device="cpu")
    jc = J_tf.init_caches(jcfg, 3, 20)
    for key, pair in caches[0].items():
        for name, x in pair.items():
            assert tuple(x.shape) == jc["periods"][0][key][name].shape[1:]
    assert tuple(caches[0]["cross_kv"]["k"].shape)[1] == jcfg.n_frames


@pytest.mark.parametrize("mode", ["float", "dualmode"])
def test_encoder_apply_matches_reference(whisper, reference, mode):
    jcfg, _, tp, frames, _ = whisper
    tcfg = T_registry.reduced_config(ARCH).replace(
        **(DUAL if mode == "dualmode" else {}))
    got = T_tf.encoder_apply(tp, tcfg, _t(frames), device=CPU)
    np.testing.assert_allclose(got.numpy(), reference[mode][0],
                               atol=TOL[mode])


@pytest.mark.parametrize("mode", ["float", "dualmode"])
def test_lm_apply_with_encoder_output_matches_reference(whisper, reference,
                                                        mode):
    """The decoder given the reference's encoder output: logits through
    the self, cross (gate 0.5) and GELU sublayers."""
    _, _, tp, _, toks = whisper
    tcfg = T_registry.reduced_config(ARCH).replace(
        **(DUAL if mode == "dualmode" else {}))
    got, caches = T_tf.lm_apply(tp, tcfg, _t(toks),
                                cross_src=_t(reference[mode][0]), device=CPU)
    assert caches is None
    np.testing.assert_allclose(got.numpy(), reference[mode][1],
                               atol=TOL[mode])
    # the encoder's output reaches the logits
    zero, _ = T_tf.lm_apply(tp, tcfg, _t(toks),
                            cross_src=_t(0 * reference[mode][0]), device=CPU)
    assert float((got - zero).abs().max()) > 0.05


def test_fused_seams_match_reference(whisper, reference):
    """norm_impl 'fused_pallas' (the plain versions of rows 14 / 15 with
    kind 'layer'): the encoder's residual-norm epilogue and every block's
    norm -> QKV prologue against the reference's dense graph."""
    _, _, tp, frames, toks = whisper
    tcfg = T_registry.reduced_config(ARCH).replace(
        norm_impl="fused_pallas", ffn_impl="fused_pallas")
    enc = T_tf.encoder_apply(tp, tcfg, _t(frames), device=CPU)
    np.testing.assert_allclose(enc.numpy(), reference["float"][0], atol=1e-5)
    logits, _ = T_tf.lm_apply(tp, tcfg, _t(toks), cross_src=enc, device=CPU)
    np.testing.assert_allclose(logits.numpy(), reference["float"][1],
                               atol=1e-5)


def test_prefill_then_decode_matches_full(whisper, reference):
    """prefill(0..n) + decode(n) logits == prefill(0..n+1) last logits
    (tests/test_models.py's check at its 2e-4), the decode step reading
    the encoder's K/V from the cross caches, not from cross_src."""
    _, _, tp, _, toks = whisper
    tcfg = T_registry.reduced_config(ARCH)
    enc = _t(reference["float"][0])
    toks = _t(toks[:, :9])
    caches = T_tf.init_caches(tcfg, 2, 32, device=CPU)
    T_tf.lm_apply(tp, tcfg, toks[:, :8], pos=0, caches=caches,
                  cross_src=enc, device=CPU)
    step, _ = T_tf.lm_apply(tp, tcfg, toks[:, 8:9], pos=8, caches=caches,
                            device=CPU)
    full, _ = T_tf.lm_apply(tp, tcfg, toks, pos=0,
                            caches=T_tf.init_caches(tcfg, 2, 32, device=CPU),
                            cross_src=enc, device=CPU)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               atol=2e-4)


REQ_LENS = ((0, 5, 4, True), (1, 9, 3, True), (2, 3, 5, False),
            (3, 7, 2, True))


def _requests(cfg, cls, array):
    """Four requests, three with their own seeded frames (1, n_frames,
    d), one without (it attends over a zero cross cache)."""
    rs = np.random.RandomState(7)
    reqs = []
    for rid, n, new, with_frames in REQ_LENS:
        prompt = rs.randint(0, cfg.vocab, size=n).tolist()
        frames = rs.normal(size=(1, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
        reqs.append(cls(rid=rid, prompt=prompt, max_new=new,
                        cross_src=array(frames) if with_frames else None))
    return reqs


def test_contiguous_engine_streams_identical_to_reference(whisper):
    """2 slots, max_seq 32: 'auto' picks the contiguous cache on both
    sides, and the frames go through each side's encoder at admission."""
    jcfg, np_params, tp, _, _ = whisper
    tcfg = T_registry.reduced_config(ARCH)
    kw = dict(n_slots=2, max_seq=32, prefill_buckets=(16,))
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **kw)
    te = ServeEngine(tcfg, tp, device=CPU, **kw)
    assert je.cache_mode == te.cache_mode == "contiguous"
    assert te.encoder_attn_impl == "naive"
    jo = je.run(_requests(jcfg, JRequest, jnp.asarray))
    to = te.run(_requests(tcfg, Request, torch.from_numpy))
    assert to == jo
    assert te.stats["cache_copies"] == len(REQ_LENS)
    assert te.stats["numeric"] == 0 and te.active == 0


def test_engine_runs_the_encoder_through_the_prefill_impl(whisper,
                                                          monkeypatch):
    """The encoder takes the prefill's softmax and an impl resolved at
    (n_frames, n_frames): an explicit blocked impl reaches it, and the
    engine's streams do not move (the plain blocked versions at f32
    orders)."""
    _, _, tp, _, _ = whisper
    tcfg = T_registry.reduced_config(ARCH)
    calls = []
    inner = T_tf.encoder_apply

    def spy(params, cfg, frames, device=None):
        calls.append((cfg.attn_impl, cfg.softmax_impl, tuple(frames.shape)))
        return inner(params, cfg, frames, device=device)
    from repro_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "encoder_apply", spy)
    kw = dict(n_slots=2, max_seq=32, prefill_buckets=(8, 16))
    plain = ServeEngine(tcfg, tp, device=CPU, **kw).run(
        _requests(tcfg, Request, torch.from_numpy))
    blocked = ServeEngine(tcfg, tp, device=CPU, prefill_attn_impl="flash",
                          decode_attn_impl="flash_decode", **kw)
    assert blocked.encoder_attn_impl == "flash"
    assert blocked.run(_requests(tcfg, Request, torch.from_numpy)) == plain
    with_frames = sum(w for *_, w in REQ_LENS)
    assert calls == ([("naive", "float", (1, tcfg.n_frames, tcfg.d_model))]
                     * with_frames
                     + [("flash", "float", (1, tcfg.n_frames, tcfg.d_model))]
                     * with_frames)


def test_engine_cache_mode_rule(whisper):
    _, _, tp, _, _ = whisper
    tcfg = T_registry.reduced_config(ARCH)
    assert not T_tf.paged_supported(tcfg)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tp, cache_mode="paged", device=CPU)
    with pytest.raises(ValueError):
        T_tf.init_paged_caches(tcfg, 4, 8, device=CPU)


def test_serve_launcher_runs_whisper(capsys):
    from repro_torch.launch import serve
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "2", "--max-seq", "64"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert "cache=contiguous" in out and "2 requests" in out
