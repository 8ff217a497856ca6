"""The port's RWKV-6 slice (rwkv6-1.6b) against the JAX reference on the
same weights and inputs: ``rwkv_time_mix`` and ``rwkv_channel_mix``
(outputs and states, from a nonzero state), reduced rwkv6 through
``lm_apply`` (dense and with the fused residual-norm seam), prefill then
decode against the reference's caches and against the full pass, the
contiguous engine against the JAX engine on tests/test_serve.py's
requests, the exact-length prefill's length check, the cache-mode rule,
the training refusal, the WKV plain version at split lengths, and the
serve launcher.

Tolerances: a sublayer's outputs and states 1e-5; logits 1e-5 of
max(1, max |reference|).  The two frameworks' f32 orders (XLA's and
PyTorch's matmul sums, the norm's exp2 / log2) differ by an ulp or two
in the normed input, which the squared-ReLU channel mix doubles in
relative terms and its 128-term sums carry: a block's output differs by
~7e-6 at magnitude 2.5, and logits of magnitude ~4 by up to 1.8e-5
(measured over three seeds).  Prefill then decode against the full pass
at the reference's own 2e-4 (tests/test_models.py).  The plain scan split
in two equals the whole bit for bit.  Greedy engine streams identical.
"""
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models import rwkv as J_rwkv
from repro.models import transformer as J_tf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.kernels import _build
from repro_torch.kernels import recurrence as rec
from repro_torch.models import rwkv as T_rwkv
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.step import check_train_arch

ARCH = "rwkv6-1.6b"
CPU = torch.device("cpu")
# tests/test_serve.py's requests and settings
REQS = [(0, [1, 2, 3, 4, 5], 5), (1, [7, 8, 9], 7), (2, [4] * 10, 4),
        (3, [2, 3], 3)]

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
def rwkv():
    jcfg = J_registry.reduced_config(ARCH)
    tcfg = T_registry.reduced_config(ARCH)
    np_params = reference_tree(
        T_tf.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu"), tcfg)
    return jcfg, np_params, params_from_numpy(np_params, tcfg, device=CPU)


def _tokens(cfg, seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape)


def _spec():
    return T_tf.rwkv_spec(T_registry.reduced_config(ARCH))


def _state(spec, rs, b):
    return {"tm_x": rs.randn(b, spec.d_model).astype(np.float32),
            "cm_x": rs.randn(b, spec.d_model).astype(np.float32),
            "wkv": (rs.randn(b, spec.n_heads, spec.head_dim, spec.head_dim)
                    * 0.3).astype(np.float32)}


def _logits_close(mine, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(mine.numpy(), ref,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _close(mine: dict, ref: dict, atol=1e-5):
    assert set(mine) == set(ref)
    for key in ref:
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, err_msg=key)


def test_rwkv_params_and_state_follow_the_reference_layout(rwkv):
    jcfg, np_params, tp = rwkv
    tcfg = T_registry.reduced_config(ARCH)
    T_tf.check_supported(T_registry.get_config(ARCH))
    layer = tp["layers"][0]
    assert tuple(layer["mixer"]["mu"].shape) == (5, tcfg.d_model)
    assert tuple(layer["mixer"]["dd_w2"].shape) == (5, tcfg.rwkv_lora_r,
                                                    tcfg.d_model)
    ref = jax.eval_shape(lambda k: J_tf.init_lm(k, jcfg),
                         jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, np_params)
    ffn = layer["ffn"]
    assert torch.equal(ffn["mu_k"], ffn["mu_r"])   # one key in the reference
    mine = T_tf.init_caches(tcfg, 3, 20, device=CPU)
    ref = J_tf.init_caches(jcfg, 3, 20)["periods"][0]["state"]
    assert set(mine[0]) == {"state"}
    for key, x in mine[0]["state"].items():
        assert tuple(x.shape) == ref[key].shape[1:] and not x.any()


@pytest.mark.parametrize("sl", [1, 7])
def test_time_and_channel_mix_match_reference(rwkv, sl):
    """Both sublayers on the same numpy input and nonzero state: outputs
    and the returned tm_x / wkv / cm_x."""
    _, np_params, tp = rwkv
    spec = _spec()
    jspec = J_rwkv.RWKVSpec(*spec)
    rs = np.random.RandomState(sl)
    x = rs.randn(2, sl, spec.d_model).astype(np.float32)
    st = _state(spec, rs, 2)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["periods"][0])
    tst = {k: _t(v) for k, v in st.items()}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    jo, js = J_rwkv.rwkv_time_mix(jp["mixer"], jspec, jnp.asarray(x),
                                  state=jst)
    to, ts = T_rwkv.rwkv_time_mix(tp["layers"][0]["mixer"], spec, _t(x),
                                  state=tst)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    _close(ts, js)
    np.testing.assert_array_equal(ts["tm_x"].numpy(), x[:, -1])
    jo, js = J_rwkv.rwkv_channel_mix(jp["ffn"], jspec, jnp.asarray(x),
                                     state=jst)
    to, ts = T_rwkv.rwkv_channel_mix(tp["layers"][0]["ffn"], spec, _t(x),
                                     state=tst)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    _close(ts, js)


@pytest.mark.parametrize("norm_impl", ["dense", "fused_pallas"])
def test_rwkv_lm_apply_matches_reference(rwkv, norm_impl):
    jcfg, np_params, tp = rwkv
    tcfg = T_registry.reduced_config(ARCH).replace(norm_impl=norm_impl)
    toks = _tokens(jcfg)
    jl, _, _ = j_lm_apply(jax.tree.map(jnp.asarray, np_params), jcfg,
                          jnp.asarray(toks))
    tl, _ = T_tf.lm_apply(tp, tcfg, _t(toks), device=CPU)
    _logits_close(tl, jl)


def test_rwkv_prefill_then_decode_matches_reference_and_full(rwkv):
    """An 8-token prefill and a decode step against the reference's
    logits and states, and the step's logits against the 9-token pass."""
    jcfg, np_params, tp = rwkv
    jp = jax.tree.map(jnp.asarray, np_params)
    tcfg = T_registry.reduced_config(ARCH)
    toks = _tokens(jcfg, 3, (2, 9))
    jc = J_tf.init_caches(jcfg, 2, 32)
    tc = T_tf.init_caches(tcfg, 2, 32, device=CPU)
    for sl, pos in ((slice(0, 8), 0), (slice(8, 9), 8)):
        jl, jc, _ = j_lm_apply(jp, jcfg, jnp.asarray(toks[:, sl]), pos=pos,
                               caches=jc)
        tl, tc = T_tf.lm_apply(tp, tcfg, _t(toks[:, sl]), pos=pos, caches=tc,
                               device=CPU)
        _logits_close(tl, jl)
        for i, layer in enumerate(tc):
            _close(layer["state"], {k: v[i] for k, v in
                                    jc["periods"][0]["state"].items()})
    full, _ = T_tf.lm_apply(tp, tcfg, _t(toks), pos=0,
                            caches=T_tf.init_caches(tcfg, 2, 32, device=CPU),
                            device=CPU)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, -1].numpy(),
                               atol=2e-4)


def test_rwkv_engine_streams_equal_reference(rwkv):
    """3 slots, max_seq 48, buckets (8, 16), which the exact-length
    prefill ignores: greedy streams token for token, 4 prefills."""
    jcfg, np_params, tp = rwkv
    kw = dict(n_slots=3, max_seq=48, prefill_buckets=(8, 16))
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **kw)
    te = ServeEngine(T_registry.reduced_config(ARCH), tp, device=CPU, **kw)
    assert te.cache_mode == je.cache_mode == "contiguous"
    assert [te._bucket(n) for n in (2, 9, 17)] == [2, 9, 17]
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in REQS])
    assert to == jo
    assert te.stats["prefills"] == je.stats["prefills"] == 4
    assert te.active == 0


def test_rwkv_overlong_prompt_raises_exact_prefill(rwkv):
    """tests/test_serve.py's check: the exact-length prefill still refuses
    a prompt past max_seq, and nothing stays queued."""
    _, _, tp = rwkv
    eng = ServeEngine(T_registry.reduced_config(ARCH), tp, n_slots=1,
                      max_seq=16, device=CPU)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=0, prompt=list(range(17)), max_new=1))
    assert eng.pending() == 0


def test_rwkv_paged_refused_auto_contiguous(rwkv):
    _, _, tp = rwkv
    tcfg = T_registry.reduced_config(ARCH)
    assert not T_tf.paged_supported(tcfg)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tp, n_slots=1, max_seq=16, cache_mode="paged",
                    device=CPU)
    eng = ServeEngine(tcfg, tp, n_slots=1, max_seq=16, device=CPU)
    assert eng.cache_mode == "contiguous"


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_training_recurrent_archs_is_refused(arch):
    mixer = "rwkv" if arch == ARCH else "mamba"
    with pytest.raises(NotImplementedError,
                       match=f"training {mixer} layers.*backward kernels"):
        check_train_arch(T_registry.reduced_config(arch))


@pytest.mark.parametrize("split", [1, 13, 31])
def test_wkv6_plain_split_and_reference_scan(split):
    """The plain WKV over 32 steps equals its first ``split`` steps then
    the rest from the carried state, bit for bit; and it equals the
    reference's step under jax.lax.scan within 1e-5."""
    rs = np.random.RandomState(split)
    b, sl, h, hd = 2, 32, 3, 16
    r, k, v = (rs.randn(b, sl, h, hd).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rs.randn(b, sl, h, hd) * 0.5 - 1.0)).astype(
        np.float32)
    u = (rs.randn(h, hd) * 0.1).astype(np.float32)
    s0 = (rs.randn(b, h, hd, hd) * 0.3).astype(np.float32)
    args = [_t(a) for a in (r, k, v, w)]
    y, s = rec.wkv6(*args, _t(u), _t(s0))
    y1, s1 = rec.wkv6(*[a[:, :split] for a in args], _t(u), _t(s0))
    y2, s2 = rec.wkv6(*[a[:, split:] for a in args], _t(u), s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, s)

    def step(st, inp):                 # repro/models/rwkv.py:114-120
        r_t, k_t, v_t, w_t = inp
        kv = k_t[..., :, None] * v_t[..., None, :]
        yt = jnp.einsum("bhk,bhkv->bhv", r_t, st + jnp.asarray(u)[..., None]
                        * kv)
        return st * w_t[..., :, None] + kv, yt
    js, jy = jax.lax.scan(step, jnp.asarray(s0), tuple(
        jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (r, k, v, w)))
    np.testing.assert_allclose(y.numpy(), np.moveaxis(np.asarray(jy), 0, 1),
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)


def test_recurrence_kernels_are_registered():
    """Both kernels sit in the launch-count registry, naming their CUDA
    source and the reference's scan they replace."""
    for name, ref in (("wkv6", "rwkv.py"), ("selective_scan", "mamba.py")):
        k = _build.KERNELS[name]
        path, line = k.replaces.rsplit(":", 1)
        assert path.endswith(ref) and k.source.endswith(f"{name}.cu")
        text = (T_registry.__file__.rsplit("src/", 1)[0] + path)
        assert "chunked_time_scan" in open(text).read().splitlines()[
            int(line) - 1]


def test_serve_launcher_runs_rwkv(capsys):
    from repro_torch.launch import serve
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "3", "--max-new", "3", "--max-seq", "64"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert "cache=contiguous" in out and "3 requests, 9 tokens" in out
