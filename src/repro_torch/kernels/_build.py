"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a`` (Hopper), then linked into one shared
library with a plain C interface that ``ctypes`` loads.  No PyTorch header
is included, so a build takes seconds, not minutes.  The output goes to
``src/repro_torch/build/<hash>/`` (listed in ``.gitignore``); the hash
covers the sources, the generated header and the flags, so an edit always
rebuilds and an unchanged tree reuses the library.

``unit_constants.h`` is generated here from the Python modules: the PWL
ROM tables of ``core/pwl.py`` (as select-chain muxes, the reference's
segment mux), the unit's constants and ``PAIR_C0``, the unit's exp2 of 0
(the pair mode's constant exponent, ``csrc/unit.cuh``), so they are
written down once.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :class:`Kernel` raises on a non-zero
return and counts the launches that went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.core import fixedpoint as fx
from repro_torch.core import pwl
from repro_torch.core import softmax_unit as unit
from repro_torch.kernels import datapath as dp

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"


def _rom(name: str, table) -> str:
    body = f"  int32_t r = {int(table[0])};\n"
    for s in range(1, len(table)):
        body += f"  r = seg == {s} ? {int(table[s])} : r;\n"
    return (f"__device__ __forceinline__ int32_t {name}(int32_t seg) {{\n"
            f"{body}  return r;\n}}\n")


def pair_c0() -> int:
    """exp2_int(0) of the unit: the word of the pair mode's zero exponent."""
    return int(unit._exp2_int(torch.zeros(1, dtype=fx.I32))[0])


def generated_header() -> str:
    """The text of ``unit_constants.h``, from the Python sources."""
    ints = {
        "IN_FRAC": fx.IN_FRAC, "IN_MIN": fx.IN_MIN, "IN_MAX": fx.IN_MAX,
        "EXP_FRAC": fx.EXP_FRAC, "T_FRAC": fx.T_FRAC,
        "LOG2E_FRAC": unit.LOG2E_FRAC, "LOG2E_Q": unit.LOG2E_Q,
        "GELU_A_Q": unit.GELU_A_Q, "GELU_C_Q": unit.GELU_C_Q,
        "PHANTOM_Q": unit.PHANTOM_Q, "SNAP_MIN": unit.SNAP_MIN,
        "N_SNAP_BUCKETS": unit.N_SNAP_BUCKETS,
        "PWL_N_SEG": pwl.N_SEG, "PWL_COEF_FRAC": pwl.COEF_FRAC,
        "PAIR_C0": pair_c0(),
    }
    floats = {"MASK_VALUE": dp.MASK_VALUE, "LOG2E": dp.LOG2E,
              "SQRT_2_OVER_PI": dp.SQRT_2_OVER_PI,
              "GELU_CUBIC": dp.GELU_CUBIC}
    out = ["// Generated by repro_torch/kernels/_build.py -- do not edit.",
           "#pragma once", "#include <cstdint>", "namespace unit {"]
    out += [f"constexpr int32_t {k} = {v};" for k, v in ints.items()]
    out += [f"constexpr float {k} = {float(v)!r}f;" for k, v in floats.items()]
    out += [_rom("rom_exp2_slope", pwl.EXP2_SLOPE_Q),
            _rom("rom_exp2_intercept", pwl.EXP2_INTERCEPT_Q),
            _rom("rom_log2_slope", pwl.LOG2_SLOPE_Q),
            _rom("rom_log2_intercept", pwl.LOG2_INTERCEPT_Q)]
    out.append("}  // namespace unit")
    return "\n".join(out) + "\n"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_key(header: str) -> str:
    h = hashlib.sha256(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, dict]:
    """Compile (if needed) and return (library path, info).  ``info`` has
    the seconds spent and the ``-Xptxas -v`` report of each source."""
    header = generated_header()
    out_dir = BUILD_ROOT / _build_key(header)
    lib = out_dir / LIB_NAME
    info = {"dir": str(out_dir), "seconds": 0.0, "cached": lib.exists(),
            "ptxas": {}}
    if lib.exists():
        return lib, info
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "unit_constants.h").write_text(header)
    nvcc = nvcc_path()
    inc = ["-I", str(out_dir), "-I", str(CSRC)]
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *inc, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, p in procs:
        log, _ = p.communicate()
        info["ptxas"][src.name] = log
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    info["seconds"] = time.perf_counter() - t0
    return lib, info


class _Library:
    """The loaded shared library (one per process, loaded at first use)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.handle = None
        self.info: dict = {}

    def get(self):
        with self._lock:
            if self.handle is None:
                path, self.info = build()
                self.handle = ctypes.CDLL(str(path))
                self.handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
                self.handle.repro_cuda_error_string.restype = ctypes.c_char_p
            return self.handle


LIBRARY = _Library()

# every kernel of the port, by name (chip_smoke.py reads counts from here)
KERNELS: dict[str, "Kernel"] = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class Kernel:
    """One C entry point of the library and its launch count.

    ``launches`` goes up by one for every launch the entry point accepted
    (return code 0) and nowhere else.  ``source`` and ``replaces`` name
    the CUDA file and the TPU kernel (file:line of its ``pallas_call``).
    """

    def __init__(self, name: str, symbol: str, argtypes, *, source: str,
                 replaces: str):
        self.name, self.symbol, self.argtypes = name, symbol, list(argtypes)
        self.source, self.replaces = source, replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(LIBRARY.get(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = LIBRARY.get().repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"kernel {self.name}: CUDA error {rc} ({msg})")
        self.launches += 1


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the C side takes it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
