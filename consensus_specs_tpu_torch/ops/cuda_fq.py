"""Batched Montgomery multiply: the CUDA kernel (csrc/mont_mul.cu) and its
dispatch — the port's counterpart of consensus_specs_tpu/ops/pallas_fq.py.

``mont_mul(a, b)`` takes (..., 15) int64 limb tensors (limbs < 2^28). On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs the
plain version, ``fq.mont_mul_plain``. The two agree limb for limb.
"""
import ctypes

import torch

from . import cuda_build, fq

# kernel launches made by mont_mul (a plain count; tests and the chip smoke
# reset it to 0 and read it back)
LAUNCHES = 0

_LIB = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type ``mont_mul_launch`` of a build of csrc/mont_mul.cu: (a, b, out,
    products, stream) -> cudaError. Returns ``lib``."""
    lib.mont_mul_launch.restype = ctypes.c_int
    lib.mont_mul_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p]
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(cuda_build.load("mont_mul"))
    return _LIB


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and starting on 16 bytes (the kernel's bulk copies)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-420 (mod p), loose in and out, broadcasting the batch."""
    global LAUNCHES
    if a.device.type == "cpu" and b.device.type == "cpu":
        return fq.mont_mul_plain(a, b)
    if a.device.type != "cuda" or a.device != b.device:
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError("mont_mul: limb tensors must be torch.int64")
    if a.shape[-1] != fq.NUM_LIMBS or b.shape[-1] != fq.NUM_LIMBS:
        raise ValueError(f"mont_mul: last dim must be {fq.NUM_LIMBS}")
    a, b = torch.broadcast_tensors(a, b)
    a, b = _aligned(a), _aligned(b)
    out = torch.empty_like(a)
    m = a.numel() // fq.NUM_LIMBS
    if m == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _lib().mont_mul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                                stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
