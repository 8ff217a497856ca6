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


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm, f32 in/out, rsqrt through the unit as 2**(-0.5 log2 v)."""
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    r = torch.exp2(-0.5 * torch.log2(ms + eps))
    return x32 * r * g.to(torch.float32)
