"""bert-base through the port's train step and launcher, against the JAX
reference's ``make_train_step`` on the same converted weights and the
same numpy batch: reduced bert, float GELU and the unit's GELU mode
(``gelu_dualmode``).

The numpy weights get nonzero layer-norm biases and a position table
scaled to unit size before both packages load them, so that the weight
decay of those leaves (the reference decays every leaf stacked under its
periods, and the top-level ``pos`` table) moves the new parameters by
~1e-4, five times the float limit: a decay mask that differs from the
reference's fails the float case.

Tolerances are the reference's (tests/test_train.py): ce rtol 1e-5, grad
norm rtol 1e-4, new parameters 2e-5 (float).  The dual-mode GELU holds
each gradient tensor within 1e-3 of its own max, as
tests/test_torch_train.py holds ``silu_dualmode``: a GELU word that flips
between XLA's and PyTorch's f32 orders moves the gradients.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.configs.base import TrainConfig
from repro.models import transformer as J_tf
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_loss_fn as j_make_loss_fn
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import latest_step
from repro_torch.configs import registry as T_registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, make_grad_fn, make_train_step
from repro_torch.tree import tree_leaves, tree_paths

CPU = torch.device("cpu")
ARCH = "bert-base"


@pytest.fixture(scope="module")
def bert_case():
    jcfg = J_registry.reduced_config(ARCH)
    params = jax.tree.map(np.asarray, J_tf.init_lm(jax.random.PRNGKey(0),
                                                   jcfg))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 1.0 if jax.tree_util.keystr(path).endswith(
            "['b']") and "norm" in jax.tree_util.keystr(path) else a),
        params)
    params["pos"] = params["pos"] * 50.0
    rs = np.random.RandomState(5)
    toks = rs.randint(0, jcfg.vocab, size=(2, 33))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    return params, batch, TrainConfig(lr=1e-3, warmup_steps=2, remat=True)


def _cfgs(act):
    return (J_registry.reduced_config(ARCH).replace(activation=act),
            T_registry.reduced_config(ARCH).replace(activation=act))


def test_float_step_matches_reference(bert_case):
    params, batch, tcfg = bert_case
    jcfg, t_cfg = _cfgs("gelu_tanh")
    jp = jax.tree.map(jnp.asarray, params)
    new_j, m_j = jax.jit(j_make_train_step(jcfg, tcfg))(
        JTrainState(jp, j_adamw_init(jp), {}),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(params, t_cfg, device=CPU)
    s_t, m_t = make_train_step(t_cfg, tcfg, CPU)(
        TrainState(tp, adamw_init(tp), {}),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(m_t["ce"]), float(m_j["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-4)
    assert float(m_t["aux"]) == float(m_j["aux"]) == 0.0
    p_j = params_from_numpy(jax.tree.map(np.asarray, new_j.params), t_cfg,
                            device=CPU)
    for (path, a), b in zip(tree_paths(s_t.params), tree_leaves(p_j)):
        assert float((a - b).abs().max()) < 2e-5, path


def test_gelu_dualmode_gradients_match_reference(bert_case):
    params, batch, tcfg = bert_case
    jcfg, t_cfg = _cfgs("gelu_dualmode")
    (_, (ce_j, _)), g_j = jax.jit(jax.value_and_grad(
        j_make_loss_fn(jcfg, tcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(params, t_cfg, device=CPU)
    (_, (ce_t, _)), g_t = make_grad_fn(t_cfg, tcfg, CPU)(
        tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(ce_t), float(ce_j), rtol=1e-5)
    g_j = params_from_numpy(jax.tree.map(np.asarray, g_j), t_cfg, device=CPU)
    for (path, gt), gj in zip(tree_paths(g_t), tree_leaves(g_j)):
        scale = float(gj.abs().max())
        assert float((gt - gj).abs().max()) <= 1e-3 * scale, path


def test_launch_train_takes_bert(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16",
        "--ckpt", str(tmp_path / "ck")])
    train.main()
    assert "[train] done" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "ck")) == 2
