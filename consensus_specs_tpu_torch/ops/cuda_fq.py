"""Batched Montgomery multiply: the CUDA kernel (csrc/mont_mul.cu) and its
dispatch — the port's counterpart of consensus_specs_tpu/ops/pallas_fq.py.

``mont_mul(a, b)`` takes (..., 15) int64 limb tensors (limbs < 2^28). On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs the
plain version, ``fq.mont_mul_plain``. The two agree limb for limb.

``pow_chain(a, bits)`` is ``fq.pow_fixed`` on the card: the chain of
Montgomery products captured once per (device, stream, shape, exponent) as
a CUDA graph whose every node is a launch of the kernel, then replayed, so
a call costs one graph launch of host time instead of one wrapper call per
product (the codec's square-root and inversion chains are ~750 products
each and launch-bound otherwise).

``capture`` and ``count_replay`` are that machinery for any graph of
kernel launches: the fused VM lowering (ops/vm_compile.py) captures its
units with them.

Threads: the counters are bumped under a lock, and a capture records its
launches in a tally of the capturing thread (they are recorded into the
graph, not run), so launches another thread makes meanwhile are counted
as they happen. A capture runs in thread-local mode on the caller's
stream (a side stream of the thread when that is the legacy default
stream, which cannot capture), so another thread may launch, allocate
and synchronize while it lasts.
"""
import ctypes
import threading

import torch

from . import cuda_build, fq

# kernel launches made by mont_mul and by pow_chain's graph replays, and
# the chain graphs captured (tests and the chip smoke reset them to 0 and
# read them back)
LAUNCHES = 0
CAPTURES = 0

_LIB = None
# (device, stream, shape, bits) -> (graph, static input, static output,
# kernel launches in the graph)
_CHAINS = {}
_CHAINS_LOCK = threading.Lock()
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


def pow_chain(a: torch.Tensor, exp_bits) -> torch.Tensor:
    """``fq.pow_fixed_steps(a, exp_bits)`` on a CUDA tensor, limb for limb,
    as one replay of the chain's CUDA graph. The first call of a key runs
    the chain step by step (its result is returned) and then captures it;
    the capture launches nothing, so LAUNCHES counts the graph's kernel
    launches at each replay."""
    global CAPTURES
    if a.device.type != "cuda":
        raise ValueError(f"pow_chain: operand on {a.device}")
    stream = torch.cuda.current_stream(a.device)
    # keyed by the card's index: "cuda" and "cuda:0" are one card
    key = (stream.device, stream.cuda_stream, tuple(a.shape),
           tuple(exp_bits))
    with _CHAINS_LOCK, torch.cuda.device(a.device):
        entry = _CHAINS.get(key)
        if entry is None:
            out = fq.pow_fixed_steps(a, exp_bits)
            static_in = a.clone()
            graph, static_out, n = capture(
                lambda: fq.pow_fixed_steps(static_in, exp_bits), stream)
            _CHAINS[key] = (graph, static_in, static_out, n)
            with _COUNT_LOCK:
                CAPTURES += 1
            return out
        graph, static_in, static_out, n = entry
        static_in.copy_(a)
        graph.replay()
        count_replay(n)
        return static_out.clone()
