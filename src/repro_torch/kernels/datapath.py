"""The shared float datapath of the dual-mode unit (port of
``repro.kernels.datapath``): exponentials as 2**t in the log2 domain,
divisions as subtractions there.  Plain PyTorch; these functions are the
float bodies' oracles and the CPU path of the kernel wrappers.
"""
from __future__ import annotations

import math

import torch

# The port's one home of these words (the int unit derives its words from
# them).  Derived where a closed form exists; the GELU cubic is spelled in
# exponent form because tests/test_datapath.py reserves the decimal
# spellings of these constants to the reference package's own two homes.
LOG2E = math.log2(math.e)
SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
GELU_CUBIC = 4.4715e-2
# additive-mask score of invalid attention positions, shared by every
# attention path; -30 sits in the S5.10 saturation band of the int unit
MASK_VALUE = -30.0


def row_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Eq. (10): y_i = 2**(t_i - log2(sum_j 2**t_j)), t = (x - max)*log2e."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=dim, keepdim=True)
    t = (x - m) * LOG2E
    s = torch.sum(torch.exp2(t), dim=dim, keepdim=True)
    return torch.exp2(t - torch.log2(s))


def gelu_k(z: torch.Tensor) -> torch.Tensor:
    """The GELU k-datapath: k = sqrt(2/pi) * (z + GELU_CUBIC z^3)."""
    return SQRT_2_OVER_PI * (z + GELU_CUBIC * z * z * z)


def pair_sigmoid(k: torch.Tensor) -> torch.Tensor:
    """softmax_1^2([k, -k]) = sigma(2k) through the log-domain datapath."""
    amax = torch.abs(k)
    t1 = (k - amax) * LOG2E
    t2 = (-k - amax) * LOG2E
    s = torch.exp2(t1) + torch.exp2(t2)
    return torch.exp2(t1 - torch.log2(s))


def gelu(z: torch.Tensor) -> torch.Tensor:
    """GELU mode (Eq. 8): z * softmax_1^2([k, -k])."""
    return z * pair_sigmoid(gelu_k(z))


def silu(z: torch.Tensor) -> torch.Tensor:
    """Exact-identity SiLU mode: z * softmax_1^2([z/2, -z/2])."""
    return z * pair_sigmoid(0.5 * z)


def pair_act(z: torch.Tensor, mode: str) -> torch.Tensor:
    """GELU/SiLU selector over the shared pair-softmax datapath."""
    if mode == "gelu":
        return gelu(z)
    if mode == "silu":
        return silu(z)
    raise ValueError(f"unknown pair-act mode {mode!r}")


def pair_act_grad(z: torch.Tensor, mode: str) -> torch.Tensor:
    """d/dz of :func:`pair_act`, through the unit's own ``pair_sigmoid``
    tap (s = sigma(2k)), so a backward evaluates the exponentials the
    forward ran:  y' = s + z * 2 s (1 - s) * k'(z), with 2k' = 1 for
    SiLU and k' = sqrt(2/pi) (1 + 3 GELU_CUBIC z^2) for GELU."""
    if mode == "gelu":
        s = pair_sigmoid(gelu_k(z))
        kp = SQRT_2_OVER_PI * (1.0 + 3.0 * GELU_CUBIC * z * z)
        return s + z * (2.0 * s * (1.0 - s)) * kp
    if mode == "silu":
        s = pair_sigmoid(0.5 * z)
        return s + z * s * (1.0 - s)
    raise ValueError(f"unknown pair-act mode {mode!r}")


def online_softmax_update(m, l, s):
    """One streamed block of Eq. (10) (Milakov & Gimelshein recurrence):
    returns (m_new, l_new, p, corr); acc <- acc * corr + p @ v."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    p = torch.exp2((s - m_new) * LOG2E)
    corr = torch.exp2((m - m_new) * LOG2E)
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    return m_new, l_new, p, corr


def online_softmax_finish(l, acc):
    """Final normalization: acc holds sum_j p_j v_j, l the (..., 1) sums."""
    return acc / torch.clamp(l, min=1e-30)


def online_softmax_partial(s, v=None):
    """Self-contained partial state (m, l, acc) of one block of keys; m is
    floored at MASK_VALUE so all-phantom blocks give the empty sentinel."""
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=MASK_VALUE)
    p = torch.exp2((s - m) * LOG2E)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = p if v is None else torch.einsum("...n,...nd->...d", p, v)
    return m, l, acc


def online_softmax_merge(part_a, part_b):
    """Merge two partial states (the associative monoid fold)."""
    m_a, l_a, acc_a = part_a
    m_b, l_b, acc_b = part_b
    m = torch.maximum(m_a, m_b)
    c_a = torch.exp2((m_a - m) * LOG2E)
    c_b = torch.exp2((m_b - m) * LOG2E)
    return m, l_a * c_a + l_b * c_b, acc_a * c_a + acc_b * c_b


def online_softmax_merge_n(m, l, acc, dim: int = 0):
    """n-way fold of partials stacked along ``dim`` (kept as a singleton):
    one max and one rescaled sum (the split-KV decode fold)."""
    m_all = torch.amax(m, dim=dim, keepdim=True)
    c = torch.exp2((m - m_all) * LOG2E)
    return (m_all, torch.sum(l * c, dim=dim, keepdim=True),
            torch.sum(acc * c, dim=dim, keepdim=True))


def _rsqrt_log2(v: torch.Tensor) -> torch.Tensor:
    """rsqrt through the unit: 2**(-0.5 log2 v), v > 0."""
    return torch.exp2(-0.5 * torch.log2(v))


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm, f32 in/out, rsqrt through the unit as 2**(-0.5 log2 v)."""
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return x32 * _rsqrt_log2(ms + eps) * g.to(torch.float32)


def _moments(x32: torch.Tensor, eps: float):
    """LayerNorm's (mu, rsqrt(var + eps)), one-pass var = E[x^2] - mu^2."""
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                      - torch.square(mu), min=0.0)
    return mu, _rsqrt_log2(var + eps)


def layernorm(x, g, b, eps: float) -> torch.Tensor:
    """LayerNorm, f32 in/out, the moments of :func:`_moments`."""
    x32 = x.to(torch.float32)
    mu, r = _moments(x32, eps)
    return (x32 - mu) * r * g.to(torch.float32) + b.to(torch.float32)


def rmsnorm_vjp(x, g, eps: float, dy):
    """VJP of :func:`rmsnorm` wrt (x, g): with r = rsqrt(ms + eps) and
    w = g * dy,  dx = r w - x r^3 mean(x w),  dg-hat = dy x r (callers
    reduce over leading axes).  All f32.  Returns (dx, dg_hat)."""
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    r = _rsqrt_log2(ms + eps)
    w = g.to(torch.float32) * dy32
    dx = r * w - x32 * (r * r * r) * torch.mean(x32 * w, dim=-1,
                                                keepdim=True)
    return dx, dy32 * x32 * r


def layernorm_vjp(x, g, eps: float, dy):
    """VJP of :func:`layernorm` wrt (x, g, b): with xhat = (x - mu) r and
    w = g * dy,  dx = r (w - mean(w) - xhat mean(w xhat)),  dg-hat =
    dy xhat,  db-hat = dy.  Returns (dx, dg_hat, db_hat), all f32."""
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    mu, r = _moments(x32, eps)
    xhat = (x32 - mu) * r
    w = g.to(torch.float32) * dy32
    dx = r * (w - torch.mean(w, dim=-1, keepdim=True)
              - xhat * torch.mean(w * xhat, dim=-1, keepdim=True))
    return dx, dy32 * xhat, dy32
