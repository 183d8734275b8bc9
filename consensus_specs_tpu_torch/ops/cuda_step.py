"""The VM step kernel (csrc/vm_step.cu) and its dispatch — the port's
counterpart of consensus_specs_tpu/ops/pallas_step.py.

``run_steps(regs, instr)`` runs every step of an instruction stream on the
(rows, n_regs, 15) int64 register file, in place. On a CUDA tensor it makes
one launch of the persistent step kernel on the current stream (one block
per row loops over all steps), or raises; on a CPU tensor it runs the plain
PyTorch steps, ``vm._run_steps_plain``. The two agree limb for limb.

``mont_mul_split_emulated`` is the kernel's split Montgomery product
(csrc/mont.cuh ``fq_mont_mul_split``) thread by thread in numpy, and
``run_steps_emulated`` the kernel's data flow through its stamp table, so
that both are tested on the CPU. ``run_steps_plain_in_lane_order`` is the
plain steps with the kernel's rule for two lanes of a unit that write one
register, the reference where a test stream has such lanes. Nothing on
the main path calls them.
"""
import ctypes
import threading

import numpy as np
import torch

from . import cuda_build, fq

# kernel launches made by run_steps, one per call on a CUDA tensor that has
# steps and rows; and the VM steps those launches ran (bumped under a lock,
# since two threads may launch; tests and the chip smoke reset them to 0
# and read them back)
LAUNCHES = 0
STEPS = 0
_COUNT_LOCK = threading.Lock()

_LIB = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the C interface of a build of csrc/vm_step.cu: ``vm_run_steps``,
    ``vm_block_threads`` and ``vm_scratch_words``. Returns ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vm_run_steps.restype = i
    lib.vm_run_steps.argtypes = [p, p, i, i, p, p, p, p, p, p, p, i, i, i, p]
    lib.vm_block_threads.restype = i
    lib.vm_block_threads.argtypes = [i, i, i, i]
    lib.vm_scratch_words.restype = ctypes.c_longlong
    lib.vm_scratch_words.argtypes = [i, i]
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(cuda_build.load("vm_step"))
    return _LIB


def block_threads(w_mul: int, w_lin: int, n_regs: int, n_steps: int) -> int:
    """Threads of the kernel's block for a call, or 0 where the launch
    cannot take it (``vm_block_threads`` in csrc/vm_step.cu; builds the
    kernel on first use)."""
    return _lib().vm_block_threads(w_mul, w_lin, n_regs, n_steps)


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
    n_regs = regs.shape[1]
    if block_threads(w_mul, w_lin, n_regs, n_steps) == 0:
        raise ValueError(
            f"w_mul={w_mul}, w_lin={w_lin}, n_regs={n_regs}, "
            f"n_steps={n_steps} do not fit one block of the step kernel: "
            "4 threads a MUL lane in whole warps plus one a LIN lane must "
            "stay <= 1024, the stamps and instruction rows inside the "
            "block's shared memory, w_lin a multiple of 4 and the step "
            "count inside the stamps (csrc/vm_step.cu vm_block_threads)")
    if lsub.data_ptr() % 4:
        raise ValueError("lsub must start on a 4-byte boundary")


def launch(lib: ctypes.CDLL, regs: torch.Tensor, instr) -> None:
    """One launch of ``lib``'s step kernel (a ``bind``-typed build of
    csrc/vm_step.cu) over every step of ``instr`` on the CUDA register
    file ``regs``, on the current stream, with its scratch; raises if the
    launch is refused. Counts nothing: ``run_steps`` is the wrapper."""
    n_steps, w_mul = instr[0].shape
    rows, n_regs, _ = regs.shape
    compact = torch.empty(lib.vm_scratch_words(rows, n_regs),
                          dtype=torch.int32, device=regs.device)
    stream = torch.cuda.current_stream(regs.device).cuda_stream
    rc = lib.vm_run_steps(regs.data_ptr(), compact.data_ptr(), rows, n_regs,
                          *(x.data_ptr() for x in instr),
                          w_mul, instr[3].shape[1], n_steps, stream)
    if rc != 0:
        raise RuntimeError(f"vm_step kernel launch failed: cudaError {rc}")


def run_steps(regs: torch.Tensor, instr) -> torch.Tensor:
    """Run every step of ``instr`` — seven (n_steps, width) tensors, int32
    register indices and a uint8 subtract mask, as ``Program.device_instr``
    gives them — on ``regs`` (rows, n_regs, 15) int64, in place."""
    global LAUNCHES, STEPS
    if regs.device.type == "cpu":
        from . import vm

        return vm._run_steps_plain(regs, instr)
    if regs.device.type != "cuda":
        raise ValueError(f"run_steps: unsupported device {regs.device}")
    if regs.dtype != torch.int64 or regs.dim() != 3 \
            or regs.shape[-1] != fq.NUM_LIMBS or not regs.is_contiguous():
        raise ValueError("regs must be a contiguous (rows, n_regs, 15) int64")
    _check_instr(regs, instr)
    if instr[0].shape[0] == 0 or regs.shape[0] == 0:
        return regs
    launch(_lib(), regs, instr)
    with _COUNT_LOCK:
        LAUNCHES += 1
        STEPS += instr[0].shape[0]
    return regs


def run_steps_emulated(regs: torch.Tensor, instr) -> torch.Tensor:
    """The step kernel's data flow, on CPU tensors, with the plain
    arithmetic: each step loads every operand, computes every lane and
    stamps each destination with (step, slot) by a maximum, then stores
    only the results whose slot holds their destination's stamp (so of two
    lanes that write one register, the later slot's result stays). Updates
    ``regs`` in place; it must agree with ``run_steps_plain_in_lane_order``
    (and so with ``vm._run_steps_plain`` where no unit repeats a
    destination in a step)."""
    from . import vm

    msa, msb, msd, lsa, lsb, lsub, lsd = (x.numpy().astype(np.int64)
                                          for x in instr)
    n_steps, w_mul = msa.shape
    n_res = w_mul + lsa.shape[1]
    stamps = np.full(regs.shape[-2], -1, dtype=np.int64)
    for s in range(n_steps):
        res = torch.cat([
            fq.mont_mul_plain(regs[..., msa[s], :], regs[..., msb[s], :]),
            vm._lin_plain(regs[..., lsa[s], :], regs[..., lsb[s], :],
                          torch.from_numpy(lsub[s]))], dim=-2)
        dests = np.concatenate([msd[s], lsd[s]])
        mine = s * n_res + np.arange(n_res)  # ordered as (step, slot)
        np.maximum.at(stamps, dests, mine)
        own = stamps[dests] == mine
        regs[..., dests[own], :] = res[..., own, :]
    return regs


def run_steps_plain_in_lane_order(regs: torch.Tensor, instr) -> torch.Tensor:
    """``vm._run_steps_plain`` for streams in which two lanes of one unit
    (MUL or LIN) write one register in a step: the later lane's result
    stays, as in the step kernel. (A scatter with a repeated index keeps
    either result; the assembler never emits one.) Every lane but the last
    of a repeated destination writes a spare register past the file's end
    instead. Returns a new register file on ``regs``' device."""
    from . import vm

    n_regs = regs.shape[-2]
    dests, spares = [], 0
    for d in (instr[2], instr[6]):
        d = d.cpu().numpy().copy()
        for s in range(d.shape[0]):
            # the last lane of each destination keeps it
            _, last = np.unique(d[s, ::-1], return_index=True)
            lose = np.ones(d.shape[1], dtype=bool)
            lose[d.shape[1] - 1 - last] = False
            d[s, lose] = n_regs + np.arange(int(lose.sum()))
            spares = max(spares, int(lose.sum()))
        dests.append(torch.from_numpy(d).to(regs.device))
    wide = torch.cat([regs, regs.new_zeros(regs.shape[:-2] + (spares, 15))],
                     dim=-2)
    msa, msb, _, lsa, lsb, lsub, _ = instr
    vm._run_steps_plain(wide, (msa, msb, dests[0], lsa, lsb, lsub, dests[1]))
    return wide[..., :n_regs, :].contiguous()


def mont_mul_split_emulated(a, b) -> np.ndarray:
    """The split Montgomery product of csrc/mont.cuh, thread by thread:
    a, b (..., 15) limbs < 2^28 (any integer array) -> (..., 15) uint64.

    Thread q of a group of 4 (FQ_SPLIT) holds limbs 4q .. 4q + 3 of a, b
    and p (limb 15 is zero); ``acc[..., q, r]`` is its accumulator slot r.
    Each shuffle of the kernel is an index into the group's slots here.
    Raises if an accumulator would leave 64 bits (the kernel's overflow
    audit)."""
    split = slots = 4
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    a, b = np.broadcast_arrays(a, b)
    batch = a.shape[:-1]

    def slices(x):
        pad = np.zeros(batch + (split * slots,), dtype=np.uint64)
        pad[..., : fq.NUM_LIMBS] = x
        return pad.reshape(batch + (split, slots))

    xa, xb = slices(a), slices(b)
    p = slices(fq.P_LIMBS.astype(np.uint64))
    mask, bits = np.uint64(fq.MASK), np.uint64(fq.LIMB_BITS)
    top = (1 << 64) - 1
    acc = np.zeros(batch + (split, slots), dtype=np.uint64)

    def add(x, y):
        s = np.asarray(np.asarray(x, dtype=object) + np.asarray(y, dtype=object))
        if s.size and int(s.max()) > top:
            raise OverflowError("accumulator past 64 bits")
        return s.astype(np.uint64)

    for i in range(fq.NUM_LIMBS):
        # __shfl_sync(a[i % 4], i / 4): a_i to every thread
        ai = xa[..., i // slots, i % slots][..., None, None]
        acc = add(acc, ai * xb)
        # m from thread 0's column 0, shuffled to the group
        m = ((acc[..., 0, 0] & mask) * np.uint64(fq.N0)) & mask
        acc = add(acc, m[..., None, None] * p)
        # every thread: slot 0's bits above 28 go into its next slot, and
        # __shfl_down_sync(slot 0 & MASK, 1) hands the low 28 bits below
        hi = acc[..., :, 0] >> bits
        nxt = np.zeros(batch + (split,), dtype=np.uint64)
        nxt[..., :-1] = acc[..., 1:, 0] & mask
        acc = np.concatenate([acc[..., 1:], nxt[..., None]], axis=-1)
        acc[..., :, 0] = add(acc[..., :, 0], hi)
    # local carry pass, then 3 rounds of shuffled carries
    out = np.zeros_like(acc)
    c = np.zeros(batch + (split,), dtype=np.uint64)
    for r in range(slots):
        cur = add(acc[..., r], c)
        out[..., r] = cur & mask
        c = cur >> bits
    for _ in range(1, split):
        # __shfl_up_sync(c, 1): thread q takes thread q-1's carry
        cin = np.zeros_like(c)
        cin[..., 1:] = c[..., :-1]
        for r in range(slots):
            cin = add(cin, out[..., r])
            out[..., r] = cin & mask
            cin = cin >> bits
        c = cin  # the top thread's carry is dropped
    return out.reshape(batch + (split * slots,))[..., : fq.NUM_LIMBS]
