"""Training the recurrent mixers (rwkv6-1.6b, jamba-v0.1-52b) on the CPU:
the port's ``chunked_time_scan`` against its plain ``time_scan``, a torch
emulation of each backward kernel's schedule against autograd through the
plain scans, the autograd Functions' plumbing under a block's remat, one
``make_train_step`` of reduced rwkv6 and reduced jamba against the
reference's jitted step on the same weights and batch, and the launcher.

The emulations follow ``csrc/wkv6_bwd.cu`` and
``csrc/selective_scan_bwd.cu`` step for step: the forward's boundary
states (before every 64th step, and the final one), the chunks walked in
reverse, each chunk recomputed from its boundary state with a checkpoint
every 8 steps, WKV's rows rebuilt from the nearest checkpoint, the
selective scan's 8-step sub-chunks recomputed whole; the cross-thread
sums through the butterfly reduce-scatter of ``csrc/scan_common.cuh``
(its lane-to-word mapping read back as the kernels read it), the warps
added in order, the per-block / per-row partials added in order.  Decays
are drawn near 0 and near 1 per channel: a backward that divided the
decay out (S_{t-1} = (S_t - k v^T) / w) would blow up there.

Tolerances.  chunked_time_scan equals time_scan bit for bit, values and
gradients.  The emulations against autograd of the plain versions: 1e-5
of max(1, max |plain|) for each output, du and dA 2e-5 (sums over every
step and row, in another order).  The step against the reference's:
ce rtol 1e-5, grad norm rtol 1e-4, new parameters 2e-5 (float, the
reference's own limits, tests/test_train.py); ``silu_dualmode``: ce rtol
1e-5 and each gradient tensor 1e-3 of its own max (the reference's test
and tests/test_torch_train.py hold it so), the reference run on the
port's SiLU words (an S5.10 word that flips between two f32 orders moves
every later mamba state).
"""
import math
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import registry as J_registry
from repro.configs.base import TrainConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_loss_fn as j_make_loss_fn
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import latest_step
from repro_torch.configs import registry as T_registry
from repro_torch.kernels import _build
from repro_torch.kernels import recurrence as rec
from repro_torch.models import scan
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.optim import adamw_update as T_adamw_update
from repro_torch.train import TrainState, make_grad_fn, make_train_step
from repro_torch.train import step as T_step
from repro_torch.tree import tree_leaves, tree_paths

CPU = torch.device("cpu")
RWKV, JAMBA = "rwkv6-1.6b", "jamba-v0.1-52b"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------- inputs, decays near 0 and near 1 ----------------

def _wkv6_inputs(rs, b, sl, h, hd):
    r, k, v = (_t(rs.randn(b, sl, h, hd)) for _ in range(3))
    # per channel: log(-log w) near +3 (w ~ 2e-9) or near -8 (w ~ 1 - 3e-4)
    centre = np.where(rs.rand(h, hd) < 0.5, 3.0, -8.0)
    w = _t(np.exp(-np.exp(centre + 0.3 * rs.randn(b, sl, h, hd))))
    u = _t(rs.randn(h, hd) * 0.5)
    s0 = _t(rs.randn(b, h, hd, hd) * 0.3)
    return r, k, v, w, u, s0


def _scan_inputs(rs, b, sl, di, ds):
    xc = _t(rs.randn(b, sl, di))
    # per channel: dt |A| up to ~80 (da ~ 2e-35) or ~1e-4 (da ~ 1)
    big = rs.rand(di) < 0.5
    dt = _t(np.where(big, rs.uniform(2.0, 5.0, (b, sl, di)),
                     rs.uniform(1e-5, 1e-4, (b, sl, di))))
    a = -_t(np.broadcast_to(np.arange(1, ds + 1), (di, ds))
            * rs.uniform(0.5, 1.0, (di, ds)))
    bm, cm = (_t(rs.randn(b, sl, ds)) for _ in range(2))
    h0 = _t(rs.randn(b, di, ds) * 0.3)
    return xc, dt, a, bm, cm, h0


# ---------------- (a) chunked_time_scan is time_scan, bit for bit ----------

@pytest.mark.parametrize("sl", [128, 100, 64])
@pytest.mark.parametrize("which", ["wkv6", "selective_scan"])
def test_chunked_time_scan_equals_time_scan_bitwise(which, sl):
    """The plain scans through chunked_time_scan (S 128: two checkpointed
    chunks; 100: indivisible, a plain scan; 64: one chunk, a plain scan)
    against the same scans through time_scan, from nonzero initial
    states: values and every input's gradient bit for bit."""
    rs = np.random.RandomState(sl)
    if which == "wkv6":
        fn, args = rec.wkv6_plain, _wkv6_inputs(rs, 2, sl, 2, 16)
    else:
        fn, args = rec.selective_scan_plain, _scan_inputs(rs, 2, sl, 24, 8)
    dy, dst = None, None

    def run():
        nonlocal dy, dst
        live = [x.clone().requires_grad_(True) for x in args]
        y, st = fn(*live)
        if dy is None:
            g = np.random.RandomState(sl + 1)
            dy, dst = _t(g.randn(*y.shape)), _t(g.randn(*st.shape))
        grads = torch.autograd.grad((y, st), live, (dy, dst))
        return [y, st, *grads]
    chunked = run()
    with mock.patch.object(rec, "chunked_time_scan", scan.time_scan):
        plain = run()
    for a, b in zip(chunked, plain):
        assert torch.equal(a, b)


def test_chunked_time_scan_checkpoints_the_chunks():
    """S 128 saves only the two chunks' boundary carries for backward: the
    steps inside a chunk are recomputed (the step runs 128 + 128 times)."""
    calls = []

    def step(h, inp):
        calls.append(1)
        return h * inp[0] + inp[1], h
    x = torch.randn(128, 3, requires_grad=True)
    h, ys = scan.chunked_time_scan(step, torch.ones(3), (x, x))
    assert len(calls) == 128
    (h.sum() + ys.sum()).backward()
    assert len(calls) == 256


# ---------------- (b) the backward kernels' schedules, emulated ------------

def lane_reduce_scatter(x, lw: int):
    """scan::lane_reduce_scatter over the lane axis of x (..., lw, N),
    read back as the kernels read it -> (..., N) the sums."""
    lanes = torch.arange(lw)
    n_tot, n, m = x.shape[-1], x.shape[-1], lw // 2
    while m >= 1:
        if n >= 2:
            up = ((lanes & m) != 0)[:, None]
            lo, hi = x[..., : n // 2], x[..., n // 2: n]
            send, keep = torch.where(up, lo, hi), torch.where(up, hi, lo)
            x = keep + send[..., lanes ^ m, :]
            n //= 2
        else:
            x = x + x[..., lanes ^ m, :]
        m //= 2
    if n_tot >= lw:                        # lane l holds words l P .. l P + P-1
        return x[..., : n_tot // lw].reshape(*x.shape[:-2], n_tot)
    rep = lw // n_tot                      # word l / rep, on rep lanes each
    words = x[..., 0].reshape(*x.shape[:-2], n_tot, rep)
    assert torch.equal(words, words[..., :1].expand_as(words))
    return words[..., 0]


@pytest.mark.parametrize("n,lw", [(64, 32), (32, 32), (16, 16), (16, 32)])
def test_lane_reduce_scatter_sums_every_word(n, lw):
    x = torch.randn(3, lw, n, generator=torch.Generator().manual_seed(n + lw))
    torch.testing.assert_close(lane_reduce_scatter(x, lw), x.sum(-2),
                               atol=1e-5, rtol=0)


def _wkv_step(s, k_t, v_t, w_t):
    return s * w_t[..., :, None] + k_t[..., :, None] * v_t[..., None, :]


def wkv6_boundaries(k, v, w, s0):
    """csrc/wkv6.cu's boundary states: before every 64th step, and the
    final state -> (B, H, ceil(S / 64) + 1, hd, hd)."""
    s, out = s0, []
    for t in range(k.shape[1]):
        if t % rec.SCAN_CHUNK == 0:
            out.append(s)
        s = _wkv_step(s, k[:, t], v[:, t], w[:, t])
    out.append(s)
    return torch.stack(out, dim=2)


def wkv6_bwd_emulated(r, k, v, w, u, bnd, dy, ds):
    """csrc/wkv6_bwd.cu's schedule: rows as threads, chunks in reverse,
    a checkpoint every 8 steps, S_{t-1} rebuilt from the nearest one, dv
    through the butterfly and the warps in order, du's partials added
    over the batch rows in order."""
    b, sl, nh, hd = r.shape
    lw = min(hd, 32)
    g = ds.clone()
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du_part = torch.zeros(b, nh, hd)
    for c in reversed(range(math.ceil(sl / rec.SCAN_CHUNK))):
        t0 = c * rec.SCAN_CHUNK
        n = min(rec.SCAN_CHUNK, sl - t0)
        s, ck = bnd[:, :, c], []
        for t in range(n):
            if t % 8 == 0:
                ck.append(s)
            s = _wkv_step(s, k[:, t0 + t], v[:, t0 + t], w[:, t0 + t])
        for t in reversed(range(n)):
            s = ck[t // 8]
            for p in range(t - t % 8, t):
                s = _wkv_step(s, k[:, t0 + p], v[:, t0 + p], w[:, t0 + p])
            r_t, k_t, v_t, w_t, dy_t = (x[:, t0 + t] for x in (r, k, v, w,
                                                               dy))
            a = (dy_t * v_t).sum(-1, keepdim=True)
            ua = u * a
            dr[:, t0 + t] = ua * k_t + (dy_t[..., None, :] * s).sum(-1)
            dk[:, t0 + t] = ua * r_t + (g * v_t[..., None, :]).sum(-1)
            dw[:, t0 + t] = (g * s).sum(-1)
            du_part = du_part + r_t * k_t * a
            x = (g + (u * r_t)[..., None] * dy_t[..., None, :]) * k_t[..., None]
            g = w_t[..., None] * g + r_t[..., None] * dy_t[..., None, :]
            parts = lane_reduce_scatter(x.reshape(b, nh, hd // lw, lw, hd), lw)
            acc = parts[:, :, 0]
            for wi in range(1, hd // lw):
                acc = acc + parts[:, :, wi]
            dv[:, t0 + t] = acc
    du = du_part[0]
    for bi in range(1, b):
        du = du + du_part[bi]
    return dr, dk, dv, dw, du, g


def _scan_step(h, a, dt_t, x_t, b_t):
    da = torch.exp(dt_t[..., None] * a)
    return h * da + (dt_t * x_t)[..., None] * b_t[:, None, :]


def scan_boundaries(xc, dt, a, bm, h0):
    """csrc/selective_scan.cu's boundary states -> (B, NB, di, ds)."""
    h, out = h0, []
    for t in range(xc.shape[1]):
        if t % rec.SCAN_CHUNK == 0:
            out.append(h)
        h = _scan_step(h, a, dt[:, t], xc[:, t], bm[:, t])
    out.append(h)
    return torch.stack(out, dim=1)


def selective_scan_bwd_emulated(xc, dt, a, bm, cm, bnd, dy, dh):
    """csrc/selective_scan_bwd.cu's schedule: channels as threads in
    blocks of 64 (two warps), chunks in reverse, a checkpoint every 8
    steps, each 8-step sub-chunk's states recomputed whole, dB / dC
    through the butterfly, the warps and then the blocks added in order,
    dA's per-row partials added over the rows in order."""
    b, sl, di = xc.shape
    ds = a.shape[-1]
    nt = rec.SCAN_BWD_THREADS
    nblk = -(-di // nt)
    g = dh.clone()
    da_part = torch.zeros(b, di, ds)
    dxc, ddt = torch.zeros_like(xc), torch.zeros_like(dt)
    db_part, dc_part = (torch.zeros(b, sl, nblk, ds) for _ in range(2))

    def st(h, t):
        return _scan_step(h, a, dt[:, t], xc[:, t], bm[:, t])
    for c in reversed(range(math.ceil(sl / rec.SCAN_CHUNK))):
        t0 = c * rec.SCAN_CHUNK
        n = min(rec.SCAN_CHUNK, sl - t0)
        h, ck = bnd[:, c], []
        for q0 in range(0, n, 8):
            ck.append(h)
            for i in range(min(8, n - q0)):
                h = st(h, t0 + q0 + i)
        for q0 in reversed(range(0, n, 8)):
            hs = [ck[q0 // 8]]
            for i in range(min(8, n - q0)):
                hs.append(st(hs[-1], t0 + q0 + i))
            for i in reversed(range(min(8, n - q0))):
                t = t0 + q0 + i
                x_t, dt_t, dy_t, b_t, c_t = (xc[:, t], dt[:, t], dy[:, t],
                                             bm[:, t], cm[:, t])
                g = g + dy_t[..., None] * c_t[:, None, :]
                d_c = dy_t[..., None] * hs[i + 1]
                da = torch.exp(dt_t[..., None] * a)
                gdh = g * da * hs[i]
                ddt[:, t] = (gdh * a).sum(-1) + (
                    g * x_t[..., None] * b_t[:, None, :]).sum(-1)
                dxc[:, t] = dt_t * (g * b_t[:, None, :]).sum(-1)
                d_b = g * (dt_t * x_t)[..., None]
                da_part = da_part + gdh * dt_t[..., None]
                g = g * da
                part = torch.zeros(b, nblk * nt, 2 * ds)
                part[:, :di] = torch.cat([d_b, d_c], dim=-1)
                red = lane_reduce_scatter(
                    part.reshape(b, nblk, nt // 32, 32, 2 * ds), 32)
                blk = red[:, :, 0]
                for wi in range(1, nt // 32):
                    blk = blk + red[:, :, wi]
                db_part[:, t], dc_part[:, t] = blk[..., :ds], blk[..., ds:]
    d_bm, d_cm = db_part[:, :, 0], dc_part[:, :, 0]
    for k in range(1, nblk):
        d_bm, d_cm = d_bm + db_part[:, :, k], d_cm + dc_part[:, :, k]
    d_a = da_part[0]
    for bi in range(1, b):
        d_a = d_a + da_part[bi]
    return dxc, ddt, d_a, d_bm, d_cm, g


def _hold(got, want, names, wide=()):
    for name, a, b in zip(names, got, want):
        tol = (2e-5 if name in wide else 1e-5) * max(1.0,
                                                     float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("sl", [1, 63, 64, 130])
@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_bwd_schedule_vs_autograd(hd, sl):
    rs = np.random.RandomState(100 * hd + sl)
    b, h = (2, 2) if hd == 16 else (1, 1)
    r, k, v, w, u, s0 = _wkv6_inputs(rs, b, sl, h, hd)
    dy = _t(rs.randn(b, sl, h, hd))
    ds = _t(rs.randn(b, h, hd, hd))
    bnd = wkv6_boundaries(k, v, w, s0)
    assert bnd.shape[2] == rec.n_boundaries(sl)
    y, s = rec.wkv6_plain(r, k, v, w, u, s0)
    assert torch.equal(bnd[:, :, -1], s)
    got = wkv6_bwd_emulated(r, k, v, w, u, bnd, dy, ds)
    want = rec.wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds)
    _hold(got, want, ("dr", "dk", "dv", "dw", "du", "ds0"), wide=("du",))


@pytest.mark.parametrize("sl", [1, 63, 64, 130])
@pytest.mark.parametrize("di,ds", [(70, 8), (64, 16)])
def test_selective_scan_bwd_schedule_vs_autograd(di, ds, sl):
    rs = np.random.RandomState(di + ds + sl)
    xc, dt, a, bm, cm, h0 = _scan_inputs(rs, 2, sl, di, ds)
    dy = _t(rs.randn(2, sl, di))
    dh = _t(rs.randn(2, di, ds))
    bnd = scan_boundaries(xc, dt, a, bm, h0)
    assert bnd.shape[1] == rec.n_boundaries(sl)
    got = selective_scan_bwd_emulated(xc, dt, a, bm, cm, bnd, dy, dh)
    want = rec.selective_scan_bwd_plain(xc, dt, a, bm, cm, h0, dy, dh)
    _hold(got, want, ("dxc", "ddt", "dA", "dBm", "dCm", "dh0"),
          wide=("dA",))


# ---------------- the Functions under a block's remat ----------------

@pytest.mark.parametrize("which", ["wkv6", "selective_scan"])
def test_functions_save_recomputed_boundaries_under_remat(which):
    """Each Function run on the CPU with its launches emulated (the
    forward writes the boundary states, the backward is the schedule
    above): under a non-reentrant checkpoint its forward runs twice and
    its backward once, on the boundary states of the recomputed forward;
    the gradients match autograd of the plain scan."""
    rs = np.random.RandomState(7)
    if which == "wkv6":
        args = _wkv6_inputs(rs, 2, 70, 2, 16)
        fn, plain, fwd_name, bwd_name = (rec.WKV6Fn, rec.wkv6_plain,
                                         "_wkv6_fwd", "wkv6_bwd")

        def emu_fwd(r, k, v, w, u, s0, boundary):
            y, s = rec.wkv6_plain(r, k, v, w, u, s0)
            return y, s, wkv6_boundaries(k, v, w, s0) if boundary else None
        emu_bwd = wkv6_bwd_emulated
    else:
        args = _scan_inputs(rs, 2, 70, 70, 8)
        fn, plain, fwd_name, bwd_name = (rec.SelectiveScanFn,
                                         rec.selective_scan_plain,
                                         "_scan_fwd", "selective_scan_bwd")

        def emu_fwd(xc, dt, a, bm, cm, h0, boundary):
            y, h = rec.selective_scan_plain(xc, dt, a, bm, cm, h0)
            return y, h, scan_boundaries(xc, dt, a, bm, h0) if boundary \
                else None
        emu_bwd = selective_scan_bwd_emulated
    made, used = [], []

    def fwd(*a, boundary):
        out = emu_fwd(*a, boundary)
        made.append(out[2])
        return out

    def bwd(*a):
        used.append(a[5])
        return emu_bwd(*a)
    live = [x.clone().requires_grad_(True) for x in args]

    def block(*xs):
        y, st = fn.apply(*xs)
        return (y * y).sum() + (st * st).sum()
    with mock.patch.object(rec, fwd_name, fwd), \
            mock.patch.object(rec, bwd_name, bwd):
        loss = checkpoint(block, *live, use_reentrant=False)
        loss.backward()
    assert len(made) == 2 and len(used) == 1 and used[0] is made[1]
    ref = [x.clone().requires_grad_(True) for x in args]
    y, st = plain(*ref)
    ((y * y).sum() + (st * st).sum()).backward()
    for a, b in zip(live, ref):
        assert float((a.grad - b.grad).abs().max()) <= 2e-5 * max(
            1.0, float(b.grad.abs().max()))


def test_backward_kernels_are_registered():
    """The two backward kernels sit in the launch-count registry beside the
    forward ones, naming their CUDA source and the reference's scan whose
    gradient they compute; serving on the CPU launches nothing."""
    for name, fwd, ref in (("wkv6_bwd", "wkv6", "rwkv.py"),
                           ("selective_scan_bwd", "selective_scan",
                            "mamba.py")):
        k = _build.KERNELS[name]
        assert k.source.endswith(f"{name}.cu")
        assert k.replaces == _build.KERNELS[fwd].replaces
        assert k.replaces.rsplit(":", 1)[0].endswith(ref)


# ---------------- (c) one train step vs the reference's ----------------

def _reference_tree(params, cfg):
    """The port's weights as numpy leaves in the reference's layout (each
    period's blocks stacked on a leading axis)."""
    n = len(cfg.pattern)
    tree = {k: jax.tree.map(lambda a: a.numpy(), v)
            for k, v in params.items() if k != "layers"}
    tree["periods"] = [jax.tree.map(
        lambda *xs: np.stack([x.numpy() for x in xs]),
        *params["layers"][j::n]) for j in range(n)]
    return tree


def _case(arch, seed):
    tcfg = T_registry.reduced_config(arch)
    params = T_tf.init_lm(tcfg, torch.Generator().manual_seed(seed), "cpu")
    np_params = _reference_tree(params, tcfg)
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, tcfg.vocab, size=(2, 129))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    return np_params, batch, TrainConfig(lr=1e-3, warmup_steps=2, remat=True)


def _route_gaps(cfg, params, tokens):
    """The smallest gap between a token's k-th and (k+1)-th router
    probabilities in each MoE layer of the port's forward: where one is
    within f32 noise, the two packages can route that token differently
    (an expert flip moves its output by O(1)), and no step comparison
    holds."""
    from repro_torch.models import moe as T_moe
    seen = []
    inner = T_moe._route

    def spy(p, s, x):
        out = inner(p, s, x)
        probs = torch.softmax(x.double() @ p["router"].double(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        seen.append(float((top[..., s.top_k - 1] - top[..., s.top_k]).min()))
        return out
    with torch.no_grad(), mock.patch.object(T_moe, "_route", spy):
        T_tf.lm_apply(params, cfg, tokens, return_hidden=True, device=CPU)
    return seen


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_float_train_step_matches_reference(arch):
    """Reduced rwkv6 / jamba, B 2 x S 128 (the reference's
    chunked_time_scan takes its chunked branch), remat on both sides.

    ce, aux and the loss rtol 1e-5, the gradient norm rtol 1e-4 against
    the reference's jitted step; each gradient tensor (the first AdamW
    moment, (1 - b1) x the clipped gradient on both sides) within 1e-4 of
    its own max; the new parameters within 2e-5 of the reference's
    ``adamw_update`` applied to the port's own gradients on the
    reference's stacked layout (which holds the decay mask, ``_decays``,
    on these layouts: a 1-D leaf under ``layers`` such as ``w_base`` at
    -6 moves by lr x 0.1 x 6 when decayed).  The two packages' new
    parameters are not compared with each other: the first AdamW step
    is g / (|g| + 1e-8), and an entry whose gradient is ~1e-8 moves by up
    to lr on an f32-rounding difference of its gradient (measured 1.0e-5
    to 1.2e-4 over seeds 0-5 on both archs, with every gradient within
    4e-5 of its tensor's max).  The batch must route no token on a top-k
    tie (jamba's MoE layers)."""
    from repro.optim import adamw_update as j_adamw_update
    np_params, batch, tcfg = _case(arch, 3)
    jcfg, t_cfg = J_registry.reduced_config(arch), T_registry.reduced_config(
        arch)
    jp = jax.tree.map(jnp.asarray, np_params)
    new_j, m_j = jax.jit(j_make_train_step(jcfg, tcfg))(
        JTrainState(jp, j_adamw_init(jp), {}),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(np_params, t_cfg, device=CPU)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    assert all(g > 1e-5 for g in _route_gaps(t_cfg, tp, tb["tokens"]))
    seen = {}

    def spy(grads, *a, **kw):
        seen["grads"] = grads
        return T_adamw_update(grads, *a, **kw)
    with mock.patch.object(T_step, "adamw_update", spy):
        s_t, m_t = make_train_step(t_cfg, tcfg, CPU)(
            TrainState(tp, adamw_init(tp), {}), tb)
    for key in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-4)
    m_ref = params_from_numpy(jax.tree.map(np.asarray, new_j.opt.m), t_cfg,
                              device=CPU)
    for (path, a), b in zip(tree_paths(s_t.opt.m), tree_leaves(m_ref)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), \
            path
    jg = jax.tree.map(jnp.asarray, _reference_tree(seen["grads"], t_cfg))
    upd = jax.jit(lambda g, p, lr: j_adamw_update(
        g, j_adamw_init(p), p, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
        weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)[0])
    p_ref = params_from_numpy(jax.tree.map(np.asarray, upd(
        jg, jp, m_j["lr"])), t_cfg, device=CPU)
    for (path, a), b in zip(tree_paths(s_t.params), tree_leaves(p_ref)):
        assert float((a - b).abs().max()) < 2e-5, path


def test_silu_dualmode_jamba_gradients_match_reference():
    """Reduced jamba with the unit's SiLU mode in its MLP and MoE FFNs
    (``silu_dualmode``), remat on, the float test's batch: ce rtol 1e-5
    and each gradient tensor within 1e-3 of its own max, the reference
    run on the port's SiLU words.

    The port's words on its own inputs are the reference unit's, bit for
    bit (held here).  But an input within f32 noise of a word boundary
    rounds to neighbouring words in the two packages (XLA's and
    PyTorch's dot orders), and a flipped word moves every later mamba
    state: with each package on its own words the worst gradient reads
    7.8e-4 to 1.64e-3 of its max over seeds 0-7, and 2.5e-6 to 3.8e-6
    on the port's words.  So the reference's STE
    takes the port's words as its forward value (its gradient stays its
    own surrogate's), and the rest of the step -- the STE, the MoE
    buffers, the scans -- is held to the limit on words that agree, as
    granite's blocks are held on the tokens whose experts agree."""
    from repro.core import activations as J_act
    from repro.core import softmax_unit as J_unit
    from repro_torch.core import activations as T_act
    np_params, batch, tcfg = _case(JAMBA, 3)
    jcfg = J_registry.reduced_config(JAMBA).replace(activation="silu_dualmode")
    t_cfg = T_registry.reduced_config(JAMBA).replace(
        activation="silu_dualmode")
    tp = params_from_numpy(np_params, t_cfg, device=CPU)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    assert all(g > 1e-5 for g in _route_gaps(t_cfg, tp, tb["tokens"]))
    n_ffn, words = t_cfg.n_layers, []
    t_silu = T_act.ACTIVATIONS["silu_dualmode"]
    j_words = jax.jit(J_unit.silu_dualmode)

    def port_silu(x):
        # the step's forward, one FFN a layer (remat's recompute repeats
        # the same bits)
        if len(words) < n_ffn:
            q = T_act._quantized(x.detach(), "silu")
            assert np.array_equal(q.numpy(), np.asarray(
                j_words(jnp.asarray(x.detach().numpy()))))
            words.append(q)
        return t_silu(x)
    with mock.patch.dict(T_act.ACTIVATIONS, {"silu_dualmode": port_silu}):
        (_, (ce_t, _)), g_t = make_grad_fn(t_cfg, tcfg, CPU)(tp, tb)
    assert len(words) == n_ffn
    traced = []

    def ref_silu(x):
        q = words[len(traced) % n_ffn]
        traced.append(x.shape)
        if x.ndim == 4:
            # MoE: the reference's (B, E, C, f) buffers, the port's
            # expert-major (E, B * C, f)
            q = q.reshape(q.shape[0], x.shape[0], -1, q.shape[-1])
            q = q.permute(1, 0, 2, 3)
        assert tuple(q.shape) == tuple(x.shape)
        s = J_act.silu(x)
        return s + jax.lax.stop_gradient(jnp.asarray(q.numpy()) - s)
    with mock.patch.dict(J_act.ACTIVATIONS, {"silu_dualmode": ref_silu}):
        (_, (ce_j, _)), g_j = jax.jit(jax.value_and_grad(
            j_make_loss_fn(jcfg, tcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    assert traced and len(traced) % n_ffn == 0
    np.testing.assert_allclose(float(ce_t), float(ce_j), rtol=1e-5)
    g_j = params_from_numpy(jax.tree.map(np.asarray, g_j), t_cfg, device=CPU)
    for (path, gt), gj in zip(tree_paths(g_t), tree_leaves(g_j)):
        scale = float(gj.abs().max())
        assert float((gt - gj).abs().max()) <= 1e-3 * scale, path


# ---------------- (d) the launcher ----------------

@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_launch_train_runs_recurrent_arch(arch, tmp_path, monkeypatch,
                                          capsys):
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16",
        "--ckpt", str(tmp_path / "ck")])
    train.main()
    out = capsys.readouterr().out
    assert "[train] done" in out and "nan" not in out
    assert latest_step(str(tmp_path / "ck")) == 2
