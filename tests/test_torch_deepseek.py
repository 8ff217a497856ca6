"""The port's deepseek-v2-lite-16b slice against the JAX reference on the
same weights and inputs: reduced deepseek (1 prefix layer, MLA over a
dense MLP, then 2 layers of MLA over a MoE of 8 experts top 2 with a
shared expert; q.k over nope + rope = 24, v 16) through ``lm_apply``, the
layout of its parameters and caches (the prefix layer first), dual-mode
block by block, a paged chunk then a decode step, the engines' greedy
streams, swap of the prefix layer's latent pools, the serve launcher and
the training refusal.

Tolerances.  Float logits 1e-5 (f32 orders) and the summed aux 1e-6;
dual-mode blocks 2e-3 on the tokens whose expert sets agree, granite's
flip rule (tests/test_torch_moe.py: a flip is admitted only at a margin at
most twice the layer's largest router-probability difference on agreeing
tokens); a decode step against the full pass at the reference's 2e-4
(tests/test_models.py); greedy streams identical.  Each case draws its
tokens from its own seeded ``np.random.RandomState``.
"""
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.models import moe as J_moe
from repro.models import transformer as J_tf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import registry as T_registry
from repro_torch.configs.base import LayerSpec, TrainConfig
from repro_torch.models import moe as T_moe
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine
from test_torch_moe import _spy_routes, route_agreement

ARCH = "deepseek-v2-lite-16b"
CPU = torch.device("cpu")
DUAL = dict(softmax_impl="dualmode", activation="silu_dualmode")

# the reference's functions, jitted (a config is static)
j_init_lm = jax.jit(J_tf.init_lm, static_argnums=1)
j_lm_apply = jax.jit(J_tf.lm_apply, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def deepseek():
    jcfg = J_registry.reduced_config(ARCH)
    np_params = jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(0),
                                                   jcfg))
    return jcfg, np_params


def _tokens(cfg, seed, shape):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape)


def test_params_and_caches_follow_the_reference_layout(deepseek):
    """Layer 0 is the reference's prefix block (MLA over a dense MLP of
    d_ff), layers 1-2 its periods (MLA over the MoE's router, stacks and
    shared MLP); the port's own init has the same shapes; every layer's
    contiguous and paged cache is the latent pair, the prefix's first."""
    jcfg, np_params = deepseek
    tcfg = T_registry.reduced_config(ARCH)
    assert T_tf.layer_specs(tcfg) == [LayerSpec("mla", "mlp"),
                                      LayerSpec("mla", "moe"),
                                      LayerSpec("mla", "moe")]
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    assert len(tp["layers"]) == 3
    for key, x in np_params["prefix"][0]["ffn"].items():
        assert torch.equal(tp["layers"][0]["ffn"][key]["w"], _t(x["w"]))
    assert set(tp["layers"][1]["ffn"]) == {"router", "gate", "up", "down",
                                           "shared"}
    assert tuple(tp["layers"][1]["ffn"]["shared"]["gate"]["w"].shape) == (
        tcfg.d_model, tcfg.moe.d_ff * tcfg.moe.n_shared)
    assert torch.equal(tp["layers"][2]["ffn"]["router"],
                       _t(np_params["periods"][0]["ffn"]["router"][1]))
    init = T_tf.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(np.shape, jax.tree.map(np.asarray, init))
    assert shapes == jax.tree.map(np.shape, jax.tree.map(np.asarray, tp))
    for mine, ref in ((T_tf.init_caches(tcfg, 3, 20, device=CPU),
                       J_tf.init_caches(jcfg, 3, 20)),
                      (T_tf.init_paged_caches(tcfg, 5, 8, device=CPU),
                       J_tf.init_paged_caches(jcfg, 5, 8))):
        assert len(mine) == 3
        for i, layer in enumerate(mine):
            want = (ref["prefix"][0] if i == 0
                    else jax.tree.map(lambda a: a[0], ref["periods"][0]))
            assert set(layer) == {"kv"}
            assert {k: tuple(x.shape) for k, x in layer["kv"].items()} == {
                k: x.shape for k, x in want["kv"].items()}


@pytest.mark.parametrize("impls", ["dense", "fused"])
def test_lm_apply_matches_reference(deepseek, impls):
    """Float logits and the summed aux (the 2 MoE layers' only: the
    prefix's MLP adds none); 'fused' runs the residual-norm epilogue's
    rows into the MoE, its router and its shared MLP (the plain versions
    of rows 14 / 12) against the reference's dense graph."""
    jcfg, np_params = deepseek
    tcfg = T_registry.reduced_config(ARCH)
    if impls == "fused":
        tcfg = tcfg.replace(norm_impl="fused_pallas", ffn_impl="fused_pallas")
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = _tokens(jcfg, 0, (2, 12))
    jl, _, ja = j_lm_apply(jax.tree.map(jnp.asarray, np_params), jcfg,
                           jnp.asarray(toks))
    tl, _, ta = T_tf.lm_apply(tp, tcfg, _t(toks), return_aux=True,
                              device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    auxes = []
    for lp, spec in zip(tp["layers"], T_tf.layer_specs(tcfg)):
        x = torch.randn((1, 5, tcfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        auxes.append(T_tf.block_apply(lp, tcfg, spec, x, None,
                                      positions=torch.arange(5)[None], pos=0,
                                      paged=None)[2])
    assert auxes[0] == 0.0 and all(float(a) > 0 for a in auxes[1:])


def test_dualmode_blocks_match_reference_on_agreeing_routes(deepseek):
    """Each dual-mode block (the unit's softmax and SiLU, the fused norm
    seams' plain versions) given the reference's block input: within
    2e-3 on the tokens whose expert sets agree, every flip within the
    flip rule; the prefix block on every token."""
    jcfg, np_params = deepseek
    jcfg = jcfg.replace(**DUAL)
    tcfg = T_registry.reduced_config(ARCH).replace(norm_impl="fused_pallas",
                                                   **DUAL)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    toks = _tokens(jcfg, 4, (2, 24))
    pos = np.broadcast_to(np.arange(24)[None], toks.shape)
    ctx = J_tf.Ctx(positions=jnp.asarray(pos), pos=0)
    k = jcfg.moe.top_k

    @jax.jit
    def prefix_block(bp, x):
        return J_tf.block_apply(bp, jcfg, jcfg.prefix[0], x, {}, ctx)[0]

    @jax.jit
    def moe_block(bp, x):
        jr = []
        with _spy_routes(J_moe, jr):
            out, _, _ = J_tf.block_apply(bp, jcfg, jcfg.pattern[0], x, {},
                                         ctx)
        return out, jr[0]

    x = jp["embed"][jnp.asarray(toks)]
    specs = T_tf.layer_specs(tcfg)
    for i in range(jcfg.n_layers):
        tr = []
        with _spy_routes(T_moe, tr):
            got, _, _ = T_tf.block_apply(tp["layers"][i], tcfg, specs[i],
                                         _t(x), None, positions=_t(pos),
                                         pos=0, paged=None)
        agree = np.ones(toks.shape, bool)
        if i == 0:
            want = prefix_block(jp["prefix"][0], x)
            assert not tr
        else:
            bp = jax.tree.map(lambda a, i=i: a[i - 1], jp["periods"][0])
            want, jr = moe_block(bp, x)
            agree, margins, diff = route_agreement(
                jr, [t.detach().numpy() for t in tr[0]],
                bp["ffn"]["router"], k)
            print(f"block {i}: {int((~agree).sum())} flips, margins "
                  f"{margins.tolist()}, agreeing router diff {diff:.2e}")
            assert (margins <= 2 * diff).all(), (i, margins, diff)
        np.testing.assert_allclose(got.numpy()[agree],
                                   np.asarray(want)[agree], atol=2e-3,
                                   err_msg=f"block {i}")
        x = want


def test_paged_chunk_then_decode_matches_reference_and_full(deepseek):
    """A chunk a row through shuffled block tables, then a two-slot
    decode at ragged depths, against the reference's paged caches (the
    prefix layer's latent pools too); and a chunk + a decode step against
    the full pass at 2e-4."""
    jcfg, np_params = deepseek
    jp = jax.tree.map(jnp.asarray, np_params)
    tcfg = T_registry.reduced_config(ARCH)
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
                                   np.asarray(jc["prefix"][0]["kv"][name]),
                                   atol=1e-5)
        np.testing.assert_allclose(
            tc[2]["kv"][name].numpy(),
            np.asarray(jc["periods"][0]["kv"][name][1]), atol=1e-5)

    seq = _t(_tokens(jcfg, 3, (2, 9)))
    c = T_tf.init_paged_caches(tcfg, 9, 8, device=CPU)
    T_tf.lm_apply(tp, tcfg, seq[:, :8], pos=0, caches=c, paged=_t(tables),
                  device=CPU)
    dec, _ = T_tf.lm_apply(tp, tcfg, seq[:, 8:9], pos=8, caches=c,
                           paged=_t(tables), device=CPU)
    full, _ = T_tf.lm_apply(tp, tcfg, seq, pos=0, caches=T_tf.init_paged_caches(
        tcfg, 9, 8, device=CPU), paged=_t(tables), device=CPU)
    np.testing.assert_allclose(dec[:, -1].numpy(), full[:, -1].numpy(),
                               atol=2e-4)


# tests/test_serve.py's requests and settings
REQS = [(0, [1, 2, 3, 4, 5], 5), (1, [7, 8, 9], 7), (2, [4] * 10, 4),
        (3, [2, 3], 3)]


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_engine_streams_equal_reference(deepseek, mode):
    """3 slots, max_seq 48, buckets (8, 16): greedy streams token for
    token; the paged engine's pools drain."""
    jcfg, np_params = deepseek
    tcfg = T_registry.reduced_config(ARCH)
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


def test_engine_under_a_tight_pool_equals_reference(deepseek):
    """A pool too small for the decode growth of three slots: both
    engines preempt by recompute (the prefix layer's rows rebuilt with
    the others), and every stream equals the reference's."""
    jcfg, np_params = deepseek
    tcfg = T_registry.reduced_config(ARCH)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    reqs = [(0, [1] * 8, 12), (1, [2] * 8, 12), (2, [3] * 9, 10)]
    kw = dict(n_slots=3, max_seq=48, num_blocks=6)
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **kw)
    te = ServeEngine(tcfg, tp, device=CPU, **kw)
    jo = je.run([JRequest(rid=r, prompt=p, max_new=n) for r, p, n in reqs])
    to = te.run([Request(rid=r, prompt=p, max_new=n) for r, p, n in reqs])
    assert to == jo
    assert te.stats["preemptions"] == je.stats["preemptions"] >= 1
    assert te.pool.in_use() == 0


def test_swap_moves_the_prefix_layers_latent_pools(deepseek):
    """A pool too small for three decoding slots: preemption by swap
    copies every layer's latent and rope-key rows out -- the prefix
    layer's first -- and back, and the streams equal an ample pool's."""
    _, np_params = deepseek
    tcfg = T_registry.reduced_config(ARCH)
    tp = params_from_numpy(np_params, tcfg, device=CPU)
    reqs = [(0, [1] * 8, 12), (1, [2] * 8, 12), (2, [3] * 9, 10)]
    kw = dict(n_slots=3, max_seq=48)
    saved = []

    def run(**extra):
        eng = ServeEngine(tcfg, tp, device=CPU, **kw, **extra)
        inner = eng._swap_out

        def swap_out(blocks):
            out = inner(blocks)
            saved.append(out)
            return out
        with mock.patch.object(eng, "_swap_out", swap_out):
            out = eng.run([Request(rid=r, prompt=p, max_new=n)
                           for r, p, n in reqs])
        return eng, out
    tight, out = run(num_blocks=6, preempt_mode="swap")
    _, ample = run()
    assert out == ample
    assert tight.stats["swap_outs"] >= 1 and tight.pool.in_use() == 0
    assert saved and all(len(s) == 3 and set(s[0]["kv"]) == {"ckv", "krope"}
                         for s in saved)
    per_block = sum(x[0].numel() * x.element_size()
                    for layer in tight.caches for x in layer["kv"].values())
    assert tight.stats["swap_bytes"] % per_block == 0


def test_serve_launcher_takes_the_arch(capsys):
    from repro_torch.launch import serve
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "2", "--max-seq", "64"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}" in out and "cache=paged" in out


def test_training_refuses_it_with_a_reason():
    """MLA training (and with it the prefix layer's decay mask) waits for
    a later training slice: every entry point raises and names MLA."""
    from repro_torch.launch import train as train_launch
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.train.step import check_train_arch
    tcfg = T_registry.reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="MLA.*h 192 / hv 128"):
        check_train_arch(T_registry.get_config(ARCH))
    for call in (lambda: check_train_arch(tcfg),
                 lambda: make_train_step(tcfg, TrainConfig(), "cpu"),
                 lambda: Trainer(tcfg, TrainConfig(), 2, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="MLA.*prefix"):
            call()
    argv = ["train", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--steps", "1"]
    with mock.patch.object(sys, "argv", argv), \
            pytest.raises(NotImplementedError, match="MLA"):
        train_launch.main()
