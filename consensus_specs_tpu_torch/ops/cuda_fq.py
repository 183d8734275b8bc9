"""The Fq kernels' wrappers: the batched Montgomery multiply
(csrc/mont_mul.cu), the port's counterpart of
consensus_specs_tpu/ops/pallas_fq.py, and the exponentiation chain
(csrc/pow_chain.cu), the counterpart of the JAX package's ``fq.pow_fixed``
(a lax.scan over that Pallas kernel).

``mont_mul(a, b)`` takes (..., 15) int64 limb tensors (limbs < 2^28). On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs the
plain version, ``fq.mont_mul_plain``. The two agree limb for limb.

``pow_chain(a, bits)`` is ``fq.pow_fixed`` on the card: the whole chain of
one exponent in one launch, each row's base and accumulator in registers,
the product by the base made only where the bit is 1; limb for limb
``fq.pow_fixed_steps``, which is what it runs on a CPU tensor. Independent
chains of one exponent stack into one call (ops/codec.py's square roots).

``chain_probe(device)`` runs csrc/pow_chain.cu's latency probe: the SM
clocks of a dependent wide multiply-add, a dependent shuffle and the REDC
digit step on one warp (the chain's latency floor counts digit steps).

``capture`` and ``count_replay`` are the machinery for a CUDA graph of
Montgomery-kernel launches: the fused VM lowering (ops/vm_compile.py)
captures its units with them.

Threads: the counters are bumped under a lock, and a capture records its
launches in a tally of the capturing thread (they are recorded into the
graph, not run), so launches another thread makes meanwhile are counted
as they happen. A capture runs in thread-local mode on the caller's
stream (a side stream of the thread when that is the legacy default
stream, which cannot capture), so another thread may launch, allocate
and synchronize while it lasts.
"""
import ctypes
import functools
import threading

import torch

from . import cuda_build, fq

# kernel launches made by mont_mul (and by the graph replays of its
# launches) and by pow_chain (tests and the chip smoke reset them to 0 and
# read them back)
LAUNCHES = 0
CHAIN_LAUNCHES = 0

_LIB = None
_CHAIN_LIB = None
_COUNT_LOCK = threading.Lock()
# per thread: ``capture`` is the launch tally of a capture in progress
# (None outside one), ``side`` the side streams captures run on
_THREAD = threading.local()


def _count_launch() -> None:
    global LAUNCHES
    tally = getattr(_THREAD, "capture", None)
    if tally is not None:
        tally[0] += 1  # recorded into the graph being captured, not run
        return
    with _COUNT_LOCK:
        LAUNCHES += 1


def _capture_stream(stream: torch.cuda.Stream) -> torch.cuda.Stream:
    """The stream a capture runs on: the caller's, or the thread's own
    side stream of the device when the caller is on the legacy default
    stream."""
    if stream != torch.cuda.default_stream(stream.device):
        return stream
    side = _THREAD.__dict__.setdefault("side", {})
    if stream.device not in side:
        side[stream.device] = torch.cuda.Stream(stream.device)
    return side[stream.device]


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


def bind_chain(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type ``pow_chain_launch`` of a build of csrc/pow_chain.cu: (a, out,
    rows, exponent words, exponent bits, stream) -> cudaError. Returns
    ``lib``."""
    lib.pow_chain_launch.restype = ctypes.c_int
    lib.pow_chain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    return lib


def _chain_lib() -> ctypes.CDLL:
    global _CHAIN_LIB
    if _CHAIN_LIB is None:
        _CHAIN_LIB = bind_chain(cuda_build.load("pow_chain"))
    return _CHAIN_LIB


# the latency probe's chains (csrc/pow_chain.cu pow_chain_probe_kernel), in
# its order: a dependent wide multiply-add, a dependent shuffle, the REDC
# digit step
PROBE_CHAINS = ("wide_mac", "shfl", "digit")


def chain_probe(device: torch.device, steps: int = 4096) -> dict:
    """SM clocks a step of each probe chain, timed with clock64() on one
    warp of ``device``: {PROBE_CHAINS name: clocks}. A probe launch is not
    a chain launch and is not counted."""
    lib = _chain_lib()
    lib.pow_chain_probe_launch.restype = ctypes.c_int
    lib.pow_chain_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p]
    out = torch.zeros(len(PROBE_CHAINS) + 1, dtype=torch.int64,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pow_chain_probe_launch(out.data_ptr(), steps, stream)
    if rc != 0:
        raise RuntimeError(f"pow_chain probe launch failed: cudaError {rc}")
    clocks = out[:len(PROBE_CHAINS)].tolist()
    return {name: c / steps for name, c in zip(PROBE_CHAINS, clocks)}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and starting on 16 bytes (the kernel's bulk copies)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-420 (mod p), loose in and out, broadcasting the batch."""
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
    # the C launch runs on the thread's current device: make it the
    # operands' card, whose stream handle it is given
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().mont_mul_launch(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), m, stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: cudaError {rc}")
    _count_launch()
    return out


def capture(fn, stream: torch.cuda.Stream):
    """Capture ``fn()`` as a CUDA graph in thread-local mode on the
    thread's capture stream for ``stream`` (which it waits on first, so
    that static inputs written on ``stream`` are ready). Returns (graph,
    fn's result, the kernel launches the graph holds): a launch made
    while capturing is recorded into the graph, not run, so it is tallied
    for the capturing thread alone and counted at each ``count_replay``.
    """
    graph = torch.cuda.CUDAGraph()
    side = _capture_stream(stream)
    if side != stream:
        side.wait_stream(stream)
    tally = _THREAD.capture = [0]
    try:
        # capture_begin/end rather than torch.cuda.graph, whose entry
        # synchronizes the whole device and runs the garbage collector: a
        # capture then costs its own thread alone
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
    finally:
        _THREAD.capture = None
    return graph, out, tally[0]


def count_replay(launches: int) -> None:
    """Count the kernel launches of one replay of a captured graph."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += launches


# exponent bits a launch takes after the top one (PC_MAX_BITS in
# csrc/pow_chain.cu): every Fq exponent of the port has at most 381
CHAIN_MAX_BITS = 512


@functools.lru_cache(maxsize=None)
def _chain_words(exp_bits: tuple) -> ctypes.Array:
    """The kernel's exponent: the bits after the top one, first-processed
    first, 32 to a uint32 word."""
    tail = exp_bits[1:]
    words = (ctypes.c_uint32 * max(1, -(-len(tail) // 32)))()
    for i, bit in enumerate(tail):
        if bit:
            words[i // 32] |= 1 << (i % 32)
    return words


def pow_chain(a: torch.Tensor, exp_bits) -> torch.Tensor:
    """``fq.pow_fixed_steps(a, exp_bits)``, limb for limb: on a CUDA tensor
    one launch of csrc/pow_chain.cu over every row, on a CPU tensor the
    plain chain. ``a`` is a contiguous (..., 15) int64 tensor;
    anything else raises, as does an exponent of more than
    CHAIN_MAX_BITS + 1 bits."""
    global CHAIN_LAUNCHES
    if a.dtype != torch.int64:
        raise TypeError("pow_chain: limb tensors must be torch.int64")
    if a.dim() == 0 or a.shape[-1] != fq.NUM_LIMBS:
        raise ValueError(f"pow_chain: last dim must be {fq.NUM_LIMBS}")
    if not a.is_contiguous():
        raise ValueError("pow_chain: the operand must be contiguous")
    exp_bits = tuple(int(b) for b in exp_bits)
    if len(exp_bits) > CHAIN_MAX_BITS + 1:
        raise ValueError(f"pow_chain: {len(exp_bits)} exponent bits, at "
                         f"most {CHAIN_MAX_BITS + 1}")
    if a.device.type == "cpu":
        return fq.pow_fixed_steps(a, exp_bits)
    if a.device.type != "cuda":
        raise ValueError(f"pow_chain: operand on {a.device}")
    out = torch.empty_like(a)
    rows = a.numel() // fq.NUM_LIMBS
    if rows == 0:
        return out
    words = _chain_words(exp_bits)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _chain_lib().pow_chain_launch(
            a.data_ptr(), out.data_ptr(), rows, ctypes.addressof(words),
            max(0, len(exp_bits) - 1), stream)
    if rc != 0:
        raise RuntimeError(f"pow_chain kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        CHAIN_LAUNCHES += 1
    return out
