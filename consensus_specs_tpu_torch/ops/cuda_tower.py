"""The tower kernels' wrappers: the JAX package's device loops over the
Pallas product (each a ``lax.scan``, one device program on the TPU) as
hand-written CUDA kernels, one launch a loop (csrc/tower.cuh is their
shared arithmetic, the port's torch functions operation for operation):

- ``fq12_ladder(fs, rs_bits)`` (csrc/fq12_ladder.cu, runtime bits):
  ``pairing.rlc_combine``'s per-item ladder, each row its own bits;
- ``fq12_pow(f, exp_bits)`` (the same kernel, static bits):
  ``pairing._pow_fixed``, the final exponentiation's x-chains;
- ``fq12_fold(fs, from_one)`` (csrc/fq12_fold.cu, sequential): the mesh
  RLC's per-slot fold (``mesh_rlc._local_fold``, from one) and the
  pairing product's list-order product (from the first value);
- ``fq12_fold_level(acc)`` (the same kernel, K = 2 over the pairs):
  ``pairing.rlc_combine``'s tree, a launch a level;
- ``miller_loop(qx, qy, px, py, ate_bits)`` (csrc/miller_loop.cu):
  ``pairing.miller_loop``;
- ``g1_fold(points)`` (csrc/g1_fold.cu): the mesh's per-slot G1 fold
  (``mesh_reduce._local_fold``);
- ``scalar_mul(qx, qy, bits, g2=)`` (csrc/scalar_mul.cu): ``curve.
  scalar_mul_fixed``'s double-and-add over static bits, G1 or G2 (the
  subgroup checks r * P).

The wrappers take CUDA tensors only: each launches its kernel or
raises. The callers (ops/pairing.py, mesh_rlc.py, mesh_reduce.py,
curve.py) call a
wrapper on a CUDA tensor and, on a CPU tensor, the plain version beside
it (the torch loop the kernel replaces, limb for limb what the kernel
computes). There is no fallback: a refused launch raises.

Each kernel has a launch counter, a plain integer bumped under a lock
where the wrapper launches (tests and the chip smoke set them to 0 and
read them back): LADDER_LAUNCHES, FOLD_LAUNCHES, MILLER_LAUNCHES,
G1_FOLD_LAUNCHES, SCALAR_MUL_LAUNCHES.
"""
import ctypes
import functools
import threading

import torch

from . import cuda_build, fq
from .cuda_fq import _chain_words

KERNELS = ("fq12_ladder", "fq12_fold", "miller_loop", "g1_fold",
           "scalar_mul")
# Montgomery products (compresses included) of the kernels' steps, as
# csrc/tower.cuh and the plain versions make them: an Fq12 product (144,
# and one compress for each of the 11 folded degrees), the Miller loop's
# doubling and addition steps, the conjugation, a G1 complete addition;
# per group (g1 over Fq, g2 over Fq2, whose zero test is 2 products) the
# Jacobian doubling, and the mixed addition's branches as tw_jac_add_mixed
# makes them: "inf" the infinity test alone (acc at infinity: Q taken),
# "hr" through the zero tests of H and R (p == -Q: zeros; p == Q: then a
# doubling), "add" the generic branch (11 products and 6 compresses on
# G1, the three zero tests)
MONTS = {"fq12_mul": 144 + 11, "dbl_step": 80, "add_step": 87,
         "conjugate": 6, "g1_add": 19,
         "g1_double": 7 + 5, "g1_inf": 1, "g1_hr": 1 + 4 + 2 + 2,
         "g1_add_mixed": 11 + 6 + 3,
         "g2_double": 35, "g2_inf": 2, "g2_hr": 2 + 18 + 4 + 4,
         "g2_add_mixed": 67}
# static exponent bits after the top one a ladder launch takes
# (TW_MAX_WORDS x 32 in csrc/tower.cuh): final_exp_is_one_full's 4,313
POW_MAX_BITS = 136 * 32
# scalar bits a scalar_mul launch takes (SM_MAX_WORDS x 32 in
# csrc/scalar_mul.cu): r's 255
SCALAR_MUL_MAX_BITS = 16 * 32
FQ12 = (12, fq.NUM_LIMBS)

LADDER_LAUNCHES = 0
FOLD_LAUNCHES = 0
MILLER_LAUNCHES = 0
G1_FOLD_LAUNCHES = 0
SCALAR_MUL_LAUNCHES = 0
_COUNTER = {"fq12_ladder": "LADDER_LAUNCHES", "fq12_fold": "FOLD_LAUNCHES",
            "miller_loop": "MILLER_LAUNCHES", "g1_fold": "G1_FOLD_LAUNCHES",
            "scalar_mul": "SCALAR_MUL_LAUNCHES"}
_COUNT_LOCK = threading.Lock()

_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# each library's launch function and its argument types
_LAUNCH = {
    "fq12_ladder": ("fq12_ladder_launch",
                    [_vp, _vp, _ll, _vp, _int, _vp, _int, _vp]),
    "fq12_fold": ("fq12_fold_launch", [_vp, _vp, _int, _ll, _int, _vp]),
    "miller_loop": ("miller_loop_launch",
                    [_vp, _vp, _vp, _vp, _vp, _ll, _vp, _int, _vp]),
    "g1_fold": ("g1_fold_launch", [_vp, _vp, _ll, _vp]),
    "scalar_mul": ("scalar_mul_launch",
                   [_vp, _vp, _vp, _vp, _vp, _ll, _int, _vp, _int, _vp]),
}
_LIBS = {}
_LIB_LOCK = threading.Lock()


def launches() -> dict:
    """{kernel: launches counted so far}."""
    return {k: globals()[_COUNTER[k]] for k in KERNELS}


def reset() -> None:
    """Set every kernel's launch counter to 0."""
    global LADDER_LAUNCHES, FOLD_LAUNCHES, MILLER_LAUNCHES, G1_FOLD_LAUNCHES
    global SCALAR_MUL_LAUNCHES
    with _COUNT_LOCK:
        LADDER_LAUNCHES = FOLD_LAUNCHES = MILLER_LAUNCHES = 0
        G1_FOLD_LAUNCHES = SCALAR_MUL_LAUNCHES = 0


def bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the launch function of a build of csrc/``name``.cu. Returns
    ``lib``."""
    fn_name, argtypes = _LAUNCH[name]
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib


def _lib(name: str) -> ctypes.CDLL:
    with _LIB_LOCK:
        if name not in _LIBS:
            _LIBS[name] = bind(name, cuda_build.load(name))
        return _LIBS[name]


def _limbs(fn: str, x: torch.Tensor, tail: tuple) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"{fn}: limb tensors must be torch.int64")
    if tuple(x.shape[-len(tail):]) != tail:
        raise ValueError(f"{fn}: trailing dims {tuple(x.shape)} must be "
                         f"{tail}")


def _on_card(fn: str, *xs: torch.Tensor) -> None:
    """Raises unless every operand lies on one CUDA device (a CPU tensor
    takes the plain version, which the caller runs)."""
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{fn}: operands on "
                         f"{sorted({str(x.device) for x in xs})}, not one "
                         "CUDA device")


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s launch function on ``device``'s current
    stream (the device made current for the call, as the C launch runs on
    the thread's current device) and count the launch; raises on a
    refused launch."""
    lib = _lib(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, _LAUNCH[name][0])(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        globals()[_COUNTER[name]] += 1


def runtime_words(rs_bits: torch.Tensor) -> torch.Tensor:
    """(N, B) msb-first bits -> (N, max(1, ceil(B / 32))) int32 words: bit
    t of row n at bit t % 32 of word t // 32 (the ladder's runtime bits,
    the order of ``cuda_fq._chain_words`` without a dropped top bit)."""
    n, b = rs_bits.shape
    w = max(1, -(-b // 32))
    bits = torch.zeros((n, w * 32), dtype=torch.int64, device=rs_bits.device)
    bits[:, :b] = rs_bits.to(torch.int64) != 0
    shifts = torch.arange(32, dtype=torch.int64, device=rs_bits.device)
    words = (bits.view(n, w, 32) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32).contiguous()


def fq12_ladder(fs: torch.Tensor, rs_bits: torch.Tensor) -> torch.Tensor:
    """(N, 12, 15) fs, (N, B) msb-first bits -> (N, 12, 15) f_i^{r_i}: from
    one, a square and a product by select(bit, f, one) at every bit. One
    launch of csrc/fq12_ladder.cu (``pairing._rlc_ladder_plain`` is its
    plain version)."""
    _limbs("fq12_ladder", fs, FQ12)
    if fs.dim() != 3 or rs_bits.dim() != 2 or rs_bits.shape[0] != fs.shape[0]:
        raise ValueError(f"fq12_ladder: fs {tuple(fs.shape)} and bits "
                         f"{tuple(rs_bits.shape)} are not (N, 12, 15), (N, B)")
    _on_card("fq12_ladder", fs, rs_bits)
    fs = fs.contiguous()
    out = torch.empty_like(fs)
    if fs.shape[0] == 0:
        return out
    words = runtime_words(rs_bits)
    _launch("fq12_ladder", fs.device, fs.data_ptr(), out.data_ptr(),
            fs.shape[0], words.data_ptr(), words.shape[1], None,
            rs_bits.shape[1])
    return out


def fq12_pow(f: torch.Tensor, exp_bits) -> torch.Tensor:
    """f^e on (..., 12, 15) for a static msb-first bit list: from f, a
    square at every bit after the top one and a product by f at a set
    bit. One launch of csrc/fq12_ladder.cu (at most POW_MAX_BITS + 1
    bits; ``pairing._pow_fixed_plain`` is its plain version)."""
    _limbs("fq12_pow", f, FQ12)
    exp_bits = tuple(int(b) for b in exp_bits)
    if not exp_bits or len(exp_bits) - 1 > POW_MAX_BITS:
        raise ValueError(f"fq12_pow: {len(exp_bits)} exponent bits, 1 to "
                         f"{POW_MAX_BITS + 1}")
    _on_card("fq12_pow", f)
    f = f.contiguous()
    out = torch.empty_like(f)
    rows = f.numel() // (12 * fq.NUM_LIMBS)
    if rows == 0:
        return out
    words = _chain_words(exp_bits)
    _launch("fq12_ladder", f.device, f.data_ptr(), out.data_ptr(), rows,
            None, 0, ctypes.addressof(words), len(exp_bits) - 1)
    return out


def fq12_fold(fs: torch.Tensor, from_one: bool) -> torch.Tensor:
    """(K, ..., 12, 15) -> (..., 12, 15): acc = acc * fs[k] in order, from
    one (one * fs[0] taken) or from fs[0]. One launch of
    csrc/fq12_fold.cu (``mesh_rlc._local_fold_plain``, from one, and
    ``pairing._fq12_product_plain`` are its plain versions)."""
    _limbs("fq12_fold", fs, FQ12)
    if fs.dim() < 3 or (fs.shape[0] < 1 and not from_one):
        raise ValueError(f"fq12_fold: {tuple(fs.shape)} holds no value to "
                         "fold from")
    _on_card("fq12_fold", fs)
    fs = fs.contiguous()
    out = fs.new_empty(fs.shape[1:])
    m = out.numel() // (12 * fq.NUM_LIMBS)
    if m == 0:
        return out
    _launch("fq12_fold", fs.device, fs.data_ptr(), out.data_ptr(),
            fs.shape[0], m, int(bool(from_one)))
    return out


def fq12_fold_level(acc: torch.Tensor) -> torch.Tensor:
    """(N, 12, 15) -> (ceil(N / 2), 12, 15): acc[2m] * acc[2m + 1], an odd
    tail carried up. One launch of csrc/fq12_fold.cu, the pairs' fold from
    the first value (``pairing._fq12_tree_level_plain`` is its plain
    version)."""
    _limbs("fq12_fold_level", acc, FQ12)
    if acc.dim() != 3:
        raise ValueError(f"fq12_fold_level: {tuple(acc.shape)} is not "
                         "(N, 12, 15)")
    _on_card("fq12_fold_level", acc)
    m = acc.shape[0] // 2
    if m == 0:
        return acc.clone()
    # (2, m, 12, 15): in[0, m] = acc[2m], in[1, m] = acc[2m + 1]
    pairs = acc[:2 * m].view((m, 2) + FQ12).transpose(0, 1).contiguous()
    head = fq12_fold(pairs, from_one=False)
    return head if acc.shape[0] % 2 == 0 else torch.cat([head, acc[-1:]])


@functools.lru_cache(maxsize=None)
def _ate_words(ate_bits: tuple):
    return _chain_words((1,) + ate_bits), len(ate_bits)


def miller_loop(qx: torch.Tensor, qy: torch.Tensor, px: torch.Tensor,
                py: torch.Tensor, ate_bits) -> torch.Tensor:
    """f_{|x|}(Q, P), conjugated, on (..., 2, 15) twist and (..., 15) G1
    affine coordinates broadcast to one batch: (..., 12, 15); ``ate_bits``
    are |x|'s bits after its top one, msb first. One launch of
    csrc/miller_loop.cu (``pairing.miller_loop_plain`` is its plain
    version)."""
    for name, x, tail in (("qx", qx, (2, fq.NUM_LIMBS)),
                          ("qy", qy, (2, fq.NUM_LIMBS)),
                          ("px", px, (fq.NUM_LIMBS,)),
                          ("py", py, (fq.NUM_LIMBS,))):
        _limbs(f"miller_loop {name}", x, tail)
    _on_card("miller_loop", qx, qy, px, py)
    batch = torch.broadcast_shapes(qx.shape[:-2], qy.shape[:-2],
                                   px.shape[:-1], py.shape[:-1])
    qx, qy = (x.expand(batch + x.shape[-2:]).contiguous() for x in (qx, qy))
    px, py = (x.expand(batch + x.shape[-1:]).contiguous() for x in (px, py))
    out = px.new_empty(batch + FQ12)
    rows = px.numel() // fq.NUM_LIMBS
    if rows == 0:
        return out
    words, n_bits = _ate_words(tuple(int(b) for b in ate_bits))
    _launch("miller_loop", px.device, qx.data_ptr(), qy.data_ptr(),
            px.data_ptr(), py.data_ptr(), out.data_ptr(), rows,
            ctypes.addressof(words), n_bits)
    return out


def g1_fold(points: torch.Tensor) -> torch.Tensor:
    """(K, 3, 15) projective G1 points -> their sum (3, 15), from infinity
    by complete additions in order. One launch of csrc/g1_fold.cu
    (``mesh_reduce._local_fold_plain`` is its plain version)."""
    _limbs("g1_fold", points, (3, fq.NUM_LIMBS))
    if points.dim() != 3:
        raise ValueError(f"g1_fold: {tuple(points.shape)} is not (K, 3, 15)")
    _on_card("g1_fold", points)
    points = points.contiguous()
    out = points.new_empty((3, fq.NUM_LIMBS))
    _launch("g1_fold", points.device, points.data_ptr(), out.data_ptr(),
            points.shape[0])
    return out


@functools.lru_cache(maxsize=None)
def _scalar_words(bits: tuple):
    """Every bit of a scalar, the first one included, 32 to a word
    (``_chain_words`` drops a top bit, so it gets a 1 put before)."""
    return _chain_words((1,) + bits)


def scalar_mul(qx: torch.Tensor, qy: torch.Tensor, bits, *,
               g2: bool) -> dict:
    """(k)Q for affine Q, k's static msb-first ``bits``: {x, y, z}
    Jacobian, broadcast over qx's and qy's batch. G1 (``g2`` false) on
    (..., 15) coordinates, G2 on (..., 2, 15); the caller names the group,
    since a (..., 2, 15) tensor is also a batch of G1 rows. One launch of
    csrc/scalar_mul.cu, none for an empty bit list, which gives the point
    at infinity (0, 0, 0) (``curve.scalar_mul_fixed_plain`` is its plain
    version)."""
    tail = (2, fq.NUM_LIMBS) if g2 else (fq.NUM_LIMBS,)
    for name, x in (("qx", qx), ("qy", qy)):
        _limbs(f"scalar_mul {name}", x, tail)
    bits = tuple(int(b) for b in bits)
    if len(bits) > SCALAR_MUL_MAX_BITS:
        raise ValueError(f"scalar_mul: {len(bits)} bits, at most "
                         f"{SCALAR_MUL_MAX_BITS}")
    _on_card("scalar_mul", qx, qy)
    batch = torch.broadcast_shapes(qx.shape[:-len(tail)],
                                   qy.shape[:-len(tail)])
    qx, qy = (x.expand(batch + tail).contiguous() for x in (qx, qy))
    if not bits:
        return {k: torch.zeros_like(qx) for k in "xyz"}
    out = {k: torch.empty_like(qx) for k in "xyz"}
    rows = qx.numel() // (len(tail) * fq.NUM_LIMBS)
    if rows == 0:
        return out
    _launch("scalar_mul", qx.device, qx.data_ptr(), qy.data_ptr(),
            out["x"].data_ptr(), out["y"].data_ptr(), out["z"].data_ptr(),
            rows, int(g2), ctypes.addressof(_scalar_words(bits)), len(bits))
    return out
