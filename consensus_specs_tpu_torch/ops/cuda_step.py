"""The fused VM-step kernel (csrc/vm_step.cu) and its dispatch — the port's
counterpart of consensus_specs_tpu/ops/pallas_step.py.

``run_steps(regs, instr)`` runs every step of an instruction stream on the
(rows, n_regs, 15) int64 register file, in place. On a CUDA tensor it makes
one C call that launches the step kernel once per step on the current
stream (or raises); on a CPU tensor it runs the plain PyTorch steps,
``vm._run_steps_plain``. The two agree limb for limb.
"""
import ctypes

import torch

from . import cuda_build, fq

# step-kernel launches made by run_steps, one per VM step (a plain count;
# tests and the chip smoke reset it to 0 and read it back)
LAUNCHES = 0

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = cuda_build.load("vm_step").vm_run_steps
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        _FN = fn
    return _FN


def _check_instr(regs: torch.Tensor, instr) -> None:
    if len(instr) != 7:
        raise ValueError("instr must be (msa, msb, msd, lsa, lsb, lsub, lsd)")
    msa, msb, msd, lsa, lsb, lsub, lsd = instr
    n_steps, w_mul = msa.shape
    w_lin = lsa.shape[1]
    for x, w in ((msa, w_mul), (msb, w_mul), (msd, w_mul), (lsa, w_lin),
                 (lsb, w_lin), (lsub, w_lin), (lsd, w_lin)):
        if x.device != regs.device or not x.is_contiguous():
            raise ValueError("instr tensors must be contiguous, on regs' device")
        if tuple(x.shape) != (n_steps, w):
            raise ValueError(f"instr shapes disagree: {tuple(x.shape)}")
        want = torch.uint8 if x is lsub else torch.int32
        if x.dtype != want:
            raise TypeError(f"instr dtype {x.dtype}, expected {want}")
    if w_mul + w_lin > 1024:
        raise ValueError("w_mul + w_lin exceeds one block of 1024 threads")


def run_steps(regs: torch.Tensor, instr) -> torch.Tensor:
    """Run every step of ``instr`` — seven (n_steps, width) tensors, int32
    register indices and a uint8 subtract mask, as ``Program.device_instr``
    gives them — on ``regs`` (rows, n_regs, 15) int64, in place."""
    global LAUNCHES
    if regs.device.type == "cpu":
        from . import vm

        return vm._run_steps_plain(regs, instr)
    if regs.device.type != "cuda":
        raise ValueError(f"run_steps: unsupported device {regs.device}")
    if regs.dtype != torch.int64 or regs.dim() != 3 \
            or regs.shape[-1] != fq.NUM_LIMBS or not regs.is_contiguous():
        raise ValueError("regs must be a contiguous (rows, n_regs, 15) int64")
    _check_instr(regs, instr)
    n_steps, w_mul = instr[0].shape
    w_lin = instr[3].shape[1]
    rows, n_regs, _ = regs.shape
    if n_steps == 0 or rows == 0:
        return regs
    stream = torch.cuda.current_stream(regs.device).cuda_stream
    rc = _kernel()(regs.data_ptr(), rows, n_regs,
                   *(x.data_ptr() for x in instr),
                   w_mul, w_lin, n_steps, stream)
    if rc != 0:
        raise RuntimeError(f"vm_step kernel launch failed: cudaError {rc}")
    LAUNCHES += n_steps
    return regs
