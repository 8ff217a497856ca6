"""PyTorch + CUDA port of ``repro`` (GELU through the dual-mode softmax unit).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``kernels``, ``models``, ``serve``, ``launch``)
so each module's counterpart is found under the same name.  Hot kernels
are hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at
first use; every kernel wrapper keeps a plain PyTorch version beside it,
which runs only for tensors on the CPU and serves as the kernel's oracle.

Numerics are float32 throughout.  TF32 is switched off for both cuBLAS
matmuls and cuDNN here, at import, so that every float32 product in the
port is a true float32 product (the reference's contract) and not a
10-bit-mantissa TF32 one.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
