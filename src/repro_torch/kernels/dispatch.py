"""Kernel dispatch registry (port of ``repro.kernels.dispatch`` for the
slices that are ported: softmax, attention, paged attention, the gated
FFN and the block's norm seams).

  softmax    'float' | 'dualmode' | 'dualmode_snap'
  attention  'auto' | 'naive' | 'flash' | 'flash_pallas' |
             'flash_pallas_int' | 'flash_pallas_int3' | 'flash_decode'
  ffn        'auto' | 'dense' | 'fused_pallas'
  norm       'auto' | 'dense' | 'fused_pallas'

ffn / norm 'auto' picks 'fused_pallas' (the CUDA kernels) on a GPU and
'dense' on the CPU, as the reference picks its Pallas kernels only on a
TPU; explicit names pass through, so 'fused_pallas' on the CPU runs the
kernels' plain versions.

'dualmode' runs the unit's row-softmax kernel (``softmax_rows``, int
words); 'dualmode_snap' is the snapped whole-row oracle of the streamed
dual-mode paths (plain PyTorch).  Resolution keeps the reference's
two-sided refusals: an impl never honors a softmax mode it does not
declare, and 'auto' never drops a dual-mode word contract.  The 'auto'
rule is the reference's without its mesh gate (the port has no mesh):
s_q=1 against >= DECODE_FLASH_MIN_KV keys -> 'flash_decode', score
tiles above 2**22 -> the blocked path of the device (:func:`blocked_impl`:
the CUDA kernel 'flash_pallas' on a GPU, the plain PyTorch 'flash' on
the CPU, as the reference picks the Pallas kernel only on a TPU), else
'naive'; under a dual-mode contract a blocked pick becomes
'flash_pallas_int' on either device (on the CPU its entry runs the
kernel's plain version).

Impls of the reference that are not ported yet are named here so that a
shape resolving to one raises NotImplementedError instead of running
something else: 'flash_ring'.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import softmax_unit as _unit
from repro_torch.device import resolve_device

from . import tiling
from .dualmode_softmax import softmax_rows

# --------------------------------------------------------------------------
# softmax (attention probabilities)
# --------------------------------------------------------------------------


def _softmax_dualmode(x: torch.Tensor) -> torch.Tensor:
    """The unit's normal mode over the last axis, through its kernel."""
    shape = x.shape
    y = softmax_rows(x.to(torch.float32).reshape(-1, shape[-1]).contiguous(),
                     precision="int")
    return y.reshape(shape).to(x.dtype)


_SOFTMAX: dict[str, Callable] = {
    "float": lambda x: torch.softmax(x, dim=-1),
    "dualmode": _softmax_dualmode,
    "dualmode_snap": lambda x: _unit.softmax_dualmode_snap(
        x.to(torch.float32), dim=-1).to(x.dtype),
}


def get_softmax(impl: str) -> Callable:
    try:
        return _SOFTMAX[impl]
    except KeyError:
        raise ValueError(
            f"unknown softmax impl {impl!r}; have {sorted(_SOFTMAX)}")


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

_ATTENTION: dict[str, Callable] = {}
_ATTENTION_MODES: dict[str, frozenset[str]] = {}
_ATTENTION_GRAD: dict[str, bool] = {}
_PAGED_ATTENTION: dict[str, Callable] = {}

# the reference's impls that a later slice of the port brings
NOT_PORTED = {
    "flash_ring": "ring attention",
}


def register_attention(name: str, fn: Callable, *, modes,
                       grad: bool) -> None:
    """fn(q, k, v, *, q_pos, kv_valid, causal, scale, softmax_impl);
    ``modes`` declares the softmax impls the entry honors, ``grad``
    whether it is differentiable (the reference's ``AttentionInfo.grad``:
    the int word paths and the decode kernels are forward-only)."""
    _ATTENTION[name] = fn
    _ATTENTION_MODES[name] = frozenset(modes)
    _ATTENTION_GRAD[name] = grad


def register_paged_attention(name: str, fn: Callable) -> None:
    """fn(q, k_pool, v_pool, *, block_tables, q_pos, kv_valid, causal,
    scale, softmax_impl) -> (B, 1, K, G, hv)."""
    _PAGED_ATTENTION[name] = fn


def _load_attention_providers() -> None:
    """Import the provider modules so that their registrations run."""
    import repro_torch.kernels.flash_attention  # noqa: F401
    import repro_torch.kernels.flash_attention_int  # noqa: F401
    import repro_torch.kernels.flash_decode  # noqa: F401
    import repro_torch.models.attention  # noqa: F401  (naive, flash)


def attention_modes(name: str) -> frozenset[str]:
    """The softmax impls ``name`` declares it honors."""
    if name not in _ATTENTION_MODES:
        _load_attention_providers()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"attention impl {name!r} ({NOT_PORTED[name]}) is not ported "
            "to PyTorch yet; a later slice of the port brings it")
    try:
        return _ATTENTION_MODES[name]
    except KeyError:
        raise ValueError(f"unknown attention impl {name!r}; "
                         f"have {sorted(_ATTENTION)}")


def use_flash(s_q: int, t: int, threshold: int = 1 << 22) -> bool:
    """Blocked path when the score tile would exceed ~16 MB f32 a head."""
    return s_q * t > threshold


def blocked_impl(device) -> str:
    """The 'auto' rule's blocked pick for ``device``: the CUDA kernel on a
    GPU, the plain PyTorch blocked loop on the CPU."""
    return "flash_pallas" if torch.device(device).type == "cuda" else "flash"


def auto_rule(s_q: int, t: int, device) -> str:
    """impl='auto': the split-KV decode kernel for one query row against a
    long cache, the device's blocked path for huge score tiles, else
    naive."""
    if s_q == 1 and t >= tiling.DECODE_FLASH_MIN_KV:
        return "flash_decode"
    return blocked_impl(device) if use_flash(s_q, t) else "naive"


def resolve_attention(impl: str, s_q: int, t_kv: int,
                      softmax_impl: str = "float", device=None) -> str:
    """Resolve 'auto' to a concrete impl for the engine or model running
    on ``device`` (None: the package's rule, the GPU), refusing any
    pairing that would drop a dual-mode word contract (see the
    reference's docstring)."""
    if softmax_impl not in _SOFTMAX:
        raise ValueError(f"unknown softmax impl {softmax_impl!r}; "
                         f"have {sorted(_SOFTMAX)}")
    if impl == "auto":
        impl = auto_rule(s_q, t_kv, resolve_device(device))
        if softmax_impl not in attention_modes(impl):
            # a float-only blocked pick under a dual-mode contract: the
            # one-sweep int kernel streams the same shapes bit-accurately
            impl = "flash_pallas_int"
    else:
        modes = attention_modes(impl)      # raises on unknown impls
        if softmax_impl not in modes:
            raise ValueError(
                f"attn_impl={impl!r} declares softmax modes "
                f"{sorted(modes)} and cannot honor "
                f"softmax_impl={softmax_impl!r} -- the dualmode word "
                "contract is never silently dropped; use attn_impl='auto'")
    return impl


def attention_grad(name: str) -> bool:
    """Whether ``name`` declares itself differentiable."""
    attention_modes(name)
    return _ATTENTION_GRAD[name]


def get_attention(impl: str) -> Callable:
    attention_modes(impl)
    return _ATTENTION[impl]


def get_paged_attention(name: str) -> Callable | None:
    """The block-table variant of ``name``, or None (dense gather)."""
    attention_modes(name)
    return _PAGED_ATTENTION.get(name)


# --------------------------------------------------------------------------
# FFN (gated-MLP execution) and norm seams
# --------------------------------------------------------------------------
#
# An ffn provider is fn(x2d, wg, wu, mode) -> (M, F), the fused gate
# matmul + activation.  A norm provider is a dict of the block's three
# fusable seams, registered as one unit:
#   'residual_norm' (x, r, g, b, *, kind, eps)  -> (x + r, norm(x + r))
#   'norm_linear'   (x, g, b, ws, *, kind, eps) -> norm(x) @ cat(ws, 1)
#   'norm_glu'      (x, g, b, wg, wu, *, kind, eps, mode)
# 'dense' maps to None: the plain unfused graph of models/layers.py.

NORM_SEAMS = ("residual_norm", "norm_linear", "norm_glu")

_FFN: dict[str, Callable | None] = {"dense": None}
_NORM: dict[str, dict[str, Callable] | None] = {"dense": None}


def register_ffn(name: str, fn: Callable) -> None:
    _FFN[name] = fn


def register_norm(name: str, seams: dict[str, Callable]) -> None:
    """Register a fused-norm provider: a dict keyed by NORM_SEAMS."""
    if set(seams) != set(NORM_SEAMS):
        raise ValueError(f"norm provider {name!r} has seams {sorted(seams)}; "
                         f"need {sorted(NORM_SEAMS)}")
    _NORM[name] = seams


def _fused_auto(device) -> str:
    return ("fused_pallas" if resolve_device(device).type == "cuda"
            else "dense")


def _lookup(table: dict, kind: str, impl: str):
    if impl not in table and impl == "fused_pallas":
        import repro_torch.kernels.fused_ffn  # noqa: F401  (registers)
        import repro_torch.kernels.fused_norm  # noqa: F401  (registers)
    try:
        return table[impl]
    except KeyError:
        raise ValueError(f"unknown {kind} impl {impl!r}; have "
                         f"{sorted(set(table) | {'auto', 'fused_pallas'})}")


def resolve_ffn(impl: str, device=None) -> str:
    """'auto' -> 'fused_pallas' on a GPU, 'dense' on the CPU; explicit
    names pass through (unknown ones raise ValueError)."""
    if impl == "auto":
        return _fused_auto(device)
    _lookup(_FFN, "ffn", impl)
    return impl


def get_ffn(impl: str) -> Callable | None:
    """None means the plain (unfused) path; otherwise the fused GLU."""
    return _lookup(_FFN, "ffn", impl)


def resolve_norm(impl: str, device=None) -> str:
    """'auto' as :func:`resolve_ffn`; explicit names pass through."""
    if impl == "auto":
        return _fused_auto(device)
    _lookup(_NORM, "norm", impl)
    return impl


def get_norm(impl: str) -> dict[str, Callable] | None:
    """None means the plain norms; otherwise the seam dict."""
    return _lookup(_NORM, "norm", impl)
