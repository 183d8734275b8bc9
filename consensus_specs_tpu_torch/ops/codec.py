"""Batched input codec: array-wide host prep for the BLS pipeline — the
port's counterpart of consensus_specs_tpu/ops/codec.py.

Every cache-missed input of the verify path would otherwise pay a per-item
pure-Python hash-to-G2 and a per-item decode + subgroup check before a
byte reaches the card. This module prepares a whole batch at once:

- **G1/G2 decompression**: vectorized limb decode (numpy bit unpack), then
  ONE shared square-root chain per batch (``fq.pow_fixed`` runs the 379
  static exponent bits once over the whole (N, 15) limb tensor; an Fq2
  root's five chains go in two stacked calls) and sign selection by
  vectorized limb compares.
- **Montgomery batch inversion**: ``_fq_batch_inverse`` is the product
  ladder (two associative scans, ONE Fermat chain for the batch, two
  multiplies per element, inv(0) == 0). It backs every division: the
  complex-method Fq2 square root, SSWU's 1/tv2 and projective -> affine.
- **Subgroup checks**: the VM programs ``g1_subgroup`` ([r]P ladder) and
  ``g2_subgroup`` (psi criterion) through ``vm.execute``.
- **hash-to-G2**: ``expand_message_xmd`` with one SHA-256 pass per XMD
  round over the whole batch; the SSWU map as batched field functions
  (its square-root branch becomes a lane select); the isogeny, the point
  addition and cofactor clearing as the ``h2g_finish`` VM program.

Placement (``_use_device``): on a CUDA device the tensor path runs, every
Montgomery product a launch of the Montgomery kernel (ops/cuda_fq.py), each
exponentiation chain one launch of the chain kernel (``cuda_fq.pow_chain``,
csrc/pow_chain.cu) and every VM program one launch of the step kernel
(ops/cuda_step.py). On the CPU the same algorithms run as a class-free
raw-int host path, as the JAX package does on its CPU backend.
``CONSENSUS_SPECS_TPU_CODEC_DEVICE=1/0`` forces the tensor path (on the
CPU: the plain PyTorch versions) or the host path.

Outputs are limb for limb the JAX package's codec and the per-item oracle
(utils/bls12_381.py), ValueError for ValueError, on valid points, invalid
encodings, non-subgroup points and infinity.
"""
import functools
import hashlib
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import bls12_381 as O
from ..utils import torch_env
from ..utils.bls12_381 import P
from . import fq, vm
from . import towers as tw

# ---------------------------------------------------------------------------
# constants (canonical Montgomery limbs unless noted)
# ---------------------------------------------------------------------------

_SQRT_BITS = [int(b) for b in bin((P + 1) // 4)[2:]]  # p = 3 mod 4 sqrt chain
_L = fq.NUM_LIMBS
_P_LIMBS = fq._int_to_limbs_np(P)
_HALF_LIMBS = fq._int_to_limbs_np((P - 1) // 2)  # sign threshold


def _fq2_const_np(x: "O.Fq2") -> np.ndarray:
    return np.stack([fq.to_mont_int(x.c0), fq.to_mont_int(x.c1)])


_CONSTS = {
    # raw-limb constant c = R^2 mod p: mont_mul(x_raw, c) == x*R == repr(x)
    "r2": fq._int_to_limbs_np((fq.R_MONT * fq.R_MONT) % P),
    "four": fq.to_mont_int(4),  # b on G1
    "b_g2": np.stack([fq.to_mont_int(4), fq.to_mont_int(4)]),
    "inv2": fq.to_mont_int(pow(2, P - 2, P)),
    "one": fq.ONE_MONT,
    "one_raw": fq._int_to_limbs_np(1),
    "sswu_a": _fq2_const_np(O.SSWU_A),
    "sswu_b": _fq2_const_np(O.SSWU_B),
    "sswu_z": _fq2_const_np(O.SSWU_Z),
    "neg_b_over_a": _fq2_const_np((-O.SSWU_B) * O.SSWU_A.inverse()),
    "x1_exc": _fq2_const_np(O.SSWU_B * (O.SSWU_Z * O.SSWU_A).inverse()),
    "one2": np.stack([fq.ONE_MONT, fq._int_to_limbs_np(0)]),
}

_G2_COMPS = ("x.0", "x.1", "y.0", "y.1")


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """A limb constant as an int64 tensor, uploaded once per device."""
    return torch.from_numpy(_CONSTS[name].astype(np.int64)).to(device)


def _cb(name: str, like: torch.Tensor) -> torch.Tensor:
    """Constant ``name`` broadcast to ``like``'s shape and device."""
    return _const(name, like.device).expand(like.shape)


# ---------------------------------------------------------------------------
# vectorized limb decode + limb compares (host numpy)
# ---------------------------------------------------------------------------


def bytes_be_to_limbs(arr: np.ndarray) -> np.ndarray:
    """(N, nbytes) big-endian byte matrix -> (N, NUM_LIMBS) raw 28-bit
    limbs (uint64), vectorized (bit unpack + weighted fold). nbytes*8 must
    fit the 420-bit limb capacity."""
    n, nb = arr.shape
    if nb * 8 > _L * fq.LIMB_BITS:
        raise ValueError(f"{nb} bytes do not fit {_L} limbs")
    bits = np.unpackbits(arr, axis=1, bitorder="big")[:, ::-1]  # LSB-first
    total = _L * fq.LIMB_BITS
    bits = np.pad(bits, ((0, 0), (0, total - bits.shape[1])))
    bits = bits.reshape(n, _L, fq.LIMB_BITS).astype(np.uint64)
    weights = np.uint64(1) << np.arange(fq.LIMB_BITS, dtype=np.uint64)
    return (bits * weights).sum(axis=2, dtype=np.uint64)


def _limbs_cmp_const(a: np.ndarray, c_limbs: np.ndarray, gt: bool
                     ) -> np.ndarray:
    """Vectorized lexicographic a > c (gt=True) or a < c (gt=False) for
    canonical-limb arrays, msb limb first. a: (N, L); c_limbs: (L,)."""
    n = a.shape[0]
    res = np.zeros(n, dtype=bool)
    eq = np.ones(n, dtype=bool)
    for k in reversed(range(a.shape[1])):
        ck = c_limbs[k]
        res |= eq & ((a[:, k] > ck) if gt else (a[:, k] < ck))
        eq &= a[:, k] == ck
    return res


def _limbs_lt_const(a: np.ndarray, c_limbs: np.ndarray) -> np.ndarray:
    return _limbs_cmp_const(a, c_limbs, gt=False)


def _limbs_gt_const(a: np.ndarray, c_limbs: np.ndarray) -> np.ndarray:
    return _limbs_cmp_const(a, c_limbs, gt=True)


def _sign_is_large_fq(y: np.ndarray) -> np.ndarray:
    """y > (p-1)/2 on RAW (non-Montgomery) canonical limbs."""
    return _limbs_gt_const(y, _HALF_LIMBS)


def _sign_is_large_fq2(y: np.ndarray) -> np.ndarray:
    """Lexicographic (c1, c0) > (-c1, -c0) on (N, 2, L) RAW canonical
    limbs: c1 > (p-1)/2, or c1 == 0 and c0 > (p-1)/2."""
    c0, c1 = y[:, 0], y[:, 1]
    c1_zero = ~c1.any(axis=1)
    return _limbs_gt_const(c1, _HALF_LIMBS) | (
        c1_zero & _limbs_gt_const(c0, _HALF_LIMBS)
    )


def _pad_batch(arr: np.ndarray) -> np.ndarray:
    """Pad the leading axis to a power of two, as the JAX package does for
    its jit shape buckets (the padding changes the batch inverse's
    product tree, so the limbs depend on it); filler rows are zeros."""
    from . import bls_backend  # shared shape-bucketing helper

    n = arr.shape[0]
    nb = bls_backend._pow2(max(1, n))
    if nb == n:
        return arr
    out = np.zeros((nb,) + arr.shape[1:], dtype=arr.dtype)
    out[:n] = arr
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Limb or flag tensor -> host numpy (limbs as uint64)."""
    a = t.cpu().numpy()
    return a.astype(np.uint64) if a.dtype == np.int64 else a


# ---------------------------------------------------------------------------
# Montgomery batch inversion (the ladder) + shared field functions
# ---------------------------------------------------------------------------


def _associative_scan(fn, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``fn`` over axis 0 with jax.lax.associative_scan's
    pairing tree (combine adjacent pairs, recurse, fill the even slots):
    ``mont_mul`` returns loose limbs, so only the same tree gives the same
    limbs."""
    n = elems.shape[0]
    if n < 2:
        return elems
    odd = _associative_scan(fn, fn(elems[0:-1:2], elems[1::2]))
    even = fn(odd[:-1] if n % 2 == 0 else odd, elems[2::2])
    out = torch.empty_like(elems)
    out[0] = elems[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def _fq_batch_inverse(a: torch.Tensor) -> torch.Tensor:
    """Montgomery batch-inversion ladder over the leading axis: two
    associative prefix/suffix product scans, ONE Fermat chain for the
    whole batch, then two multiplies per element. inv(0) == 0 (matching
    fq.inv and the oracle), zero lanes masked out of the ladder."""
    zero = fq.is_zero(a)
    one = _cb("one", a)
    safe = fq.select(zero, one, a)
    pref = _associative_scan(fq.mont_mul, safe)
    suff = _associative_scan(fq.mont_mul, safe.flip(0)).flip(0)
    total_inv = fq.inv(pref[-1])  # the batch's single inversion chain
    left = torch.cat([one[:1], pref[:-1]], dim=0)
    right = torch.cat([suff[1:], one[:1]], dim=0)
    out = fq.mont_mul(fq.mont_mul(left, right), total_inv)
    return fq.select(zero, torch.zeros_like(a), out)


def _fq2_batch_inverse(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 u)^-1 = conj / norm, the norms inverted through ONE shared
    ladder. a: (N, 2, L); inv(0) == 0."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    norm = fq.add(fq.mont_mul(a0, a0), fq.mont_mul(a1, a1))
    ni = _fq_batch_inverse(norm)
    return torch.stack(
        [fq.mont_mul(a0, ni), fq.neg(fq.mont_mul(a1, ni))], dim=-2)


def _fq2_sqrt(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Fq2 square root, complex method, with the oracle's Fq2.sqrt
    root CHOICE (bit-identical, not merely +/- equivalent). v: (N, 2, L),
    loose ok. Returns (root canonical (N, 2, L), ok (N,)): ok is False
    exactly where the oracle returns None. Five square-root chains in two
    stacked pow_fixed calls (each row's chain is its own, so stacking is
    exact) and one batch inversion (b / 2x0)."""
    a, b = v[..., 0, :], v[..., 1, :]
    inv2 = _cb("inv2", a)
    norm = fq.add(fq.mont_mul(a, a), fq.mont_mul(b, b))
    # alpha = sqrt(norm); the b == 0 lanes' sqrt(a) and sqrt(-a)
    alpha, sa, sna = fq.pow_fixed(
        torch.stack([norm, a, fq.neg(a)]), _SQRT_BITS).unbind(0)
    d1 = fq.mont_mul(fq.add(a, alpha), inv2)
    d2 = fq.mont_mul(fq.sub(a, alpha), inv2)
    x0a, x0b = fq.pow_fixed(torch.stack([d1, d2]), _SQRT_BITS).unbind(0)
    ok_a = fq.eq(fq.mont_mul(x0a, x0a), d1)
    x0 = fq.select(ok_a, x0a, x0b)
    x1 = fq.mont_mul(b, _fq_batch_inverse(fq.add(x0, x0)))
    # b == 0 lanes: (sqrt(a), 0) if a is a residue else (0, sqrt(-a))
    ok_sa = fq.eq(fq.mont_mul(sa, sa), a)
    zeros = torch.zeros_like(a)
    b_zero = fq.is_zero(b)
    r0 = fq.select(b_zero, fq.select(ok_sa, sa, zeros), x0)
    r1 = fq.select(b_zero, fq.select(ok_sa, zeros, sna), x1)
    r = torch.stack([fq.canonical(r0), fq.canonical(r1)], dim=-2)
    ok = tw.fq2_eq(tw.fq2_square(r), torch.stack([a, b], dim=-2))
    return r, ok


def _demont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery repr -> canonical RAW integer limbs. Sign and parity are
    properties of the VALUE (a Montgomery residue's limbs have unrelated
    parity), so every sgn0 / lexicographic-sign test goes through this."""
    r = fq.mont_mul(x, _const("one_raw", x.device))  # v*R * 1 * R^-1 = v
    return torch.where(fq._geq_p(r)[..., None], fq._sub_p(r), r)


def _g1_decode(x_raw: torch.Tensor):
    """(N, L) raw x limbs (< p) -> Montgomery x, candidate y, -y (all
    canonical), the RAW y value (for the host's sign compare) and the
    on-curve flag, via one shared sqrt chain."""
    x = fq.canonical(fq.mont_mul(x_raw, _const("r2", x_raw.device)))
    y2 = fq.add(fq.mont_mul(fq.mont_mul(x, x), x), _cb("four", x))
    cand = fq.pow_fixed(y2, _SQRT_BITS)
    ok = fq.eq(fq.mont_mul(cand, cand), y2)
    y = fq.canonical(cand)
    yneg = fq.canonical(fq.neg(y))
    return x, y, yneg, _demont(y), ok


def _fq2_canonical_neg(y: torch.Tensor) -> torch.Tensor:
    return torch.stack([fq.canonical(fq.neg(y[..., 0, :])),
                        fq.canonical(fq.neg(y[..., 1, :]))], dim=-2)


def _g2_decode(x_raw: torch.Tensor):
    """(N, 2, L) raw x limbs -> Montgomery x, candidate y, -y, RAW y, and
    the on-curve flag."""
    x = fq.canonical(fq.mont_mul(x_raw, _const("r2", x_raw.device)))
    x3 = tw.fq2_mul(tw.fq2_square(x), x)
    y2 = fq.add(x3, _cb("b_g2", x3))
    y, ok = _fq2_sqrt(y2)
    yneg = _fq2_canonical_neg(y)
    y_raw = torch.stack([_demont(y[..., 0, :]), _demont(y[..., 1, :])],
                        dim=-2)
    return x, y, yneg, y_raw, ok


def _sgn0(v: torch.Tensor) -> torch.Tensor:
    """RFC 9380 sgn0 for Fq2 limb tensors (N, 2, L), Montgomery form in."""
    c0 = _demont(v[..., 0, :])
    c1 = _demont(v[..., 1, :])
    sign0 = (c0[..., 0] & 1).bool()
    zero0 = (c0 == 0).all(dim=-1)
    sign1 = (c1[..., 0] & 1).bool()
    return sign0 | (zero0 & sign1)


def _gprime(x: torch.Tensor) -> torch.Tensor:
    """g'(x) = x^3 + A'x + B' on the SSWU isogenous curve."""
    x3 = tw.fq2_mul(tw.fq2_square(x), x)
    ax = tw.fq2_mul(_cb("sswu_a", x), x)
    return fq.add(fq.add(x3, ax), _cb("sswu_b", x3))


def _sswu_map(u: torch.Tensor):
    """Batched simplified SWU onto the isogenous curve (oracle
    map_to_curve_sswu_g2), u: (N, 2, L) canonical -> (x, y, ok). The
    data-dependent sqrt branch becomes a lane select; both candidate
    square roots ride the shared chains."""
    u2 = tw.fq2_square(u)
    tv1 = tw.fq2_mul(_cb("sswu_z", u2), u2)
    tv2 = fq.add(tw.fq2_square(tv1), tv1)
    tv2_zero = tw.fq2_is_zero(tv2)
    one2 = _cb("one2", tv2)
    inv_tv2 = _fq2_batch_inverse(tw.fq2_select(tv2_zero, one2, tv2))
    x1_gen = tw.fq2_mul(_cb("neg_b_over_a", u2), fq.add(one2, inv_tv2))
    x1 = tw.fq2_select(tv2_zero, _cb("x1_exc", u2), x1_gen)
    gx1 = _gprime(x1)
    y1, ok1 = _fq2_sqrt(gx1)
    x2 = tw.fq2_mul(tv1, x1)
    gx2 = _gprime(x2)
    y2c, ok2 = _fq2_sqrt(gx2)
    x = tw.fq2_select(ok1, x1, x2)
    y = tw.fq2_select(ok1, y1, y2c)
    flip = _sgn0(u) != _sgn0(y)
    y = tw.fq2_select(flip, _fq2_canonical_neg(y), y)
    x = torch.stack([fq.canonical(x[..., 0, :]), fq.canonical(x[..., 1, :])],
                    dim=-2)
    return x, y, ok1 | ok2


def _proj_to_affine(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor):
    """Projective (x = X/Z) -> affine, the whole batch through one
    ladder."""
    zi = _fq2_batch_inverse(Z)
    x = tw.fq2_mul(X, zi)
    y = tw.fq2_mul(Y, zi)
    return (
        torch.stack([fq.canonical(x[..., 0, :]), fq.canonical(x[..., 1, :])],
                    dim=-2),
        torch.stack([fq.canonical(y[..., 0, :]), fq.canonical(y[..., 1, :])],
                    dim=-2),
    )


# public, test-facing wrappers ------------------------------------------------


def fq_batch_inverse(a, device=None) -> np.ndarray:
    """Batch inversion ladder (Montgomery form in/out, inv(0) == 0)."""
    dev = resolve_device(device)
    return _to_numpy(_fq_batch_inverse(fq.limbs_from_numpy(a, dev)))


def fq2_sqrt_batch(v, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Batched Fq2 sqrt; returns (roots (N,2,L) canonical, ok (N,))."""
    dev = resolve_device(device)
    r, ok = _fq2_sqrt(fq.limbs_from_numpy(v, dev))
    return _to_numpy(r), _to_numpy(ok)


# ---------------------------------------------------------------------------
# VM-program subgroup checks + hash finish
# ---------------------------------------------------------------------------


def _layout(kind: str, n_items: int, mesh=None):
    from . import bls_backend  # lazy: bls_backend imports this module

    return bls_backend._FoldLayout(kind, 0, n_items, mesh)


def g1_subgroup_check_batch(points: np.ndarray, device=None,
                            mesh=None) -> np.ndarray:
    """points: (M, 2, L) canonical affine (ON the curve) -> bool (M,).
    Tensor path: the [r]P complete-addition ladder as a VM program (its
    rows sharded over ``mesh`` when given). Host path: the GLV criterion
    on raw ints."""
    dev = torch_env.resolve(device, mesh)
    m = points.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool)
    if not _use_device(dev):
        pts = [
            (fq.from_mont_limbs(points[i, 0]), fq.from_mont_limbs(points[i, 1]))
            for i in range(m)
        ]
        return np.asarray(_g1_subgroup_host(pts), dtype=bool)
    lay = _layout("g1_subgroup", m, mesh)
    arr = np.zeros((lay.nb, 2, _L), dtype=np.uint64)
    arr[:m] = points
    ins: Dict[str, np.ndarray] = {}
    lay.scatter(ins, arr, lambda c: f"pt.{'xy'[c]}")
    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=dev,
                     mesh=mesh)
    rz = np.zeros((m, _L), dtype=np.uint64)
    for i in range(m):
        r, ns = lay.split(i)
        rz[i] = out[f"{ns}rz"][r]
    return _to_numpy(fq.is_zero(fq.limbs_from_numpy(rz, dev)))


def g2_subgroup_check_batch(points: np.ndarray, device=None,
                            mesh=None) -> np.ndarray:
    """points: (M, 4, L) canonical affine [x.0, x.1, y.0, y.1] (ON the
    curve) -> bool (M,). Tensor path: the psi-criterion VM program (its
    rows sharded over ``mesh`` when given). Host path: the same criterion
    on raw ints."""
    dev = torch_env.resolve(device, mesh)
    m = points.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool)
    if not _use_device(dev):
        pts = [
            (
                (fq.from_mont_limbs(points[i, 0]),
                 fq.from_mont_limbs(points[i, 1])),
                (fq.from_mont_limbs(points[i, 2]),
                 fq.from_mont_limbs(points[i, 3])),
            )
            for i in range(m)
        ]
        return np.asarray(_g2_subgroup_host(pts), dtype=bool)
    lay = _layout("g2_subgroup", m, mesh)
    arr = np.zeros((lay.nb, 4, _L), dtype=np.uint64)
    arr[:m] = points
    ins: Dict[str, np.ndarray] = {}
    lay.scatter(ins, arr, lambda c: f"pt.{_G2_COMPS[c]}")
    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=dev,
                     mesh=mesh)
    d = np.zeros((m, 4, _L), dtype=np.uint64)
    for i in range(m):
        r, ns = lay.split(i)
        for j in range(4):
            d[i, j] = out[f"{ns}d.{j}"][r]
    return _to_numpy(fq.is_zero(fq.limbs_from_numpy(d, dev))).all(axis=1)


def _h2g_finish_batch(q0: np.ndarray, q1: np.ndarray, device,
                      mesh=None) -> np.ndarray:
    """(M, 4, L) SSWU outputs q0, q1 -> (M, 4, L) hashed affine G2 points
    (isogeny + add + clear-cofactor as a VM program, its rows sharded
    over ``mesh`` when given, then one batched projective -> affine
    ladder on ``device``)."""
    m = q0.shape[0]
    lay = _layout("h2g_finish", m, mesh)
    a0 = np.zeros((lay.nb, 4, _L), dtype=np.uint64)
    a1 = np.zeros((lay.nb, 4, _L), dtype=np.uint64)
    a0[:m] = q0
    a1[:m] = q1
    ins: Dict[str, np.ndarray] = {}
    lay.scatter(ins, a0, lambda c: f"q0.{_G2_COMPS[c]}")
    lay.scatter(ins, a1, lambda c: f"q1.{_G2_COMPS[c]}")
    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=device,
                     mesh=mesh)
    proj = np.zeros((m, 3, 2, _L), dtype=np.uint64)
    for i in range(m):
        r, ns = lay.split(i)
        for ci, cname in enumerate(("x", "y", "z")):
            proj[i, ci, 0] = out[f"{ns}h.{cname}.0"][r]
            proj[i, ci, 1] = out[f"{ns}h.{cname}.1"][r]
    proj_t = fq.limbs_from_numpy(proj, device)
    x, y = _proj_to_affine(proj_t[:, 0], proj_t[:, 1], proj_t[:, 2])
    return np.concatenate([_to_numpy(x), _to_numpy(y)], axis=1)  # (M, 4, L)


# ---------------------------------------------------------------------------
# batched expand_message_xmd / hash_to_field
# ---------------------------------------------------------------------------


def sha256_many(blobs: Sequence[bytes]) -> List[bytes]:
    """SHA-256 digests of a batch (hashlib; one pass over the batch per
    XMD round)."""
    return [hashlib.sha256(b).digest() for b in blobs]


def expand_message_xmd_batch(
    messages: Sequence[bytes], dst: bytes, len_in_bytes: int
) -> List[bytes]:
    """RFC 9380 expand_message_xmd over a whole batch: one SHA-256 pass
    per XMD round (1 + ell passes in all)."""
    if len(dst) > 255:
        raise ValueError("DST too long")
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    n = len(messages)
    if n == 0:
        return []
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * 64
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = sha256_many(
        [z_pad + bytes(m) + l_i_b + b"\x00" + dst_prime for m in messages]
    )
    b0_arr = np.frombuffer(b"".join(b0), dtype=np.uint8).reshape(n, 32)
    prev = sha256_many([d + b"\x01" + dst_prime for d in b0])
    rounds = [prev]
    for i in range(2, ell + 1):
        prev_arr = np.frombuffer(b"".join(prev), dtype=np.uint8).reshape(n, 32)
        xored = (b0_arr ^ prev_arr).tobytes()
        suffix = bytes([i]) + dst_prime
        prev = sha256_many(
            [xored[32 * j : 32 * (j + 1)] + suffix for j in range(n)]
        )
        rounds.append(prev)
    return [
        b"".join(r[j] for r in rounds)[:len_in_bytes] for j in range(n)
    ]


def hash_to_field_fq2_batch(
    messages: Sequence[bytes], count: int, dst: bytes
) -> np.ndarray:
    """(N, count, 2, L) canonical Montgomery field draws (oracle
    hash_to_field_fq2 per message, batched through the expander)."""
    len_in_bytes = count * 2 * O.L_FIELD
    uniform = expand_message_xmd_batch(messages, dst, len_in_bytes)
    n = len(messages)
    out = np.zeros((n, count, 2, _L), dtype=np.uint64)
    for i, u in enumerate(uniform):
        for c in range(count):
            for j in range(2):
                off = O.L_FIELD * (j + c * 2)
                out[i, c, j] = fq.to_mont_int(
                    int.from_bytes(u[off : off + O.L_FIELD], "big") % P
                )
    return out


def hash_to_g2_batch(messages: Sequence[bytes], dst: bytes,
                     device=None, mesh=None) -> np.ndarray:
    """Batched RFC 9380 hash_to_curve: returns (N, 4, L) canonical affine
    G2 limb stacks, bit-identical to ec_to_affine(oracle.hash_to_g2(msg,
    dst)) per message. ``mesh`` shards the finishing program's rows."""
    dev = torch_env.resolve(device, mesh)
    n = len(messages)
    if n == 0:
        return np.zeros((0, 4, _L), dtype=np.uint64)
    if not _use_device(dev):
        out = np.zeros((n, 4, _L), dtype=np.uint64)
        for i, (x, y) in enumerate(_hash_to_g2_host(messages, dst)):
            out[i, 0] = fq.to_mont_int(x[0])
            out[i, 1] = fq.to_mont_int(x[1])
            out[i, 2] = fq.to_mont_int(y[0])
            out[i, 3] = fq.to_mont_int(y[1])
        return out
    us = hash_to_field_fq2_batch(messages, 2, dst)  # (n, 2, 2, L)
    u_all = np.concatenate([us[:, 0], us[:, 1]], axis=0)  # (2n, 2, L)
    x, y, ok = _sswu_map(fq.limbs_from_numpy(_pad_batch(u_all), dev))
    x, y, ok = _to_numpy(x), _to_numpy(y), _to_numpy(ok)
    if not ok[: 2 * n].all():  # cannot happen for valid parameters
        raise ValueError("SSWU: no square root found")
    q = np.concatenate([x[: 2 * n], y[: 2 * n]], axis=1)  # (2n, 4, L)
    return _h2g_finish_batch(q[:n], q[n : 2 * n], dev, mesh=mesh)


# ---------------------------------------------------------------------------
# host (CPU) batched path: class-free Python ints
# ---------------------------------------------------------------------------
# On the CPU the limb math of the tensor path is compute-bound, while
# CPython's bignum pow/mulmod takes microseconds, so the host path runs the
# SAME algorithms on raw ints, batched where batching pays on a CPU: one
# SHA-256 pass per expand_message_xmd round for the whole batch, one
# inversion ladder (int_batch_inverse) shared by every division in a pass,
# and class-free Jacobian ladders. Outputs are bit-identical to the oracle
# on both paths.


def _use_device(device: torch.device) -> bool:
    """Codec placement: the tensor path on a CUDA device, the raw-int host
    path on the CPU. CONSENSUS_SPECS_TPU_CODEC_DEVICE=1/0 forces one or the
    other (tests use 1 to run the tensor path on the plain versions)."""
    mode = os.environ.get("CONSENSUS_SPECS_TPU_CODEC_DEVICE", "auto")
    if mode == "1":
        return True
    if mode == "0":
        return False
    return torch.device(device).type != "cpu"


_X_ABS = 0xD201000000010000  # |x|, the BLS parameter magnitude
_HALF_INT = (P - 1) // 2  # lexicographic sign threshold
_PSI_CX_T = (O._PSI_CX.c0, O._PSI_CX.c1)
_PSI_CY_T = (O._PSI_CY.c0, O._PSI_CY.c1)
_ONE_T = (1, 0)


def int_batch_inverse(vals: Sequence[int]) -> List[int]:
    """Montgomery batch-inversion ladder on Python ints mod p: ONE
    inversion for the whole batch + 3 multiplies per element; inv(0) == 0
    (zero lanes skipped, matching fq_batch_inverse)."""
    n = len(vals)
    out = [0] * n
    pref = [1] * n
    acc = 1
    for i, v in enumerate(vals):
        pref[i] = acc
        if v:
            acc = acc * v % P
    inv = pow(acc, -1, P)  # extgcd: far cheaper than a Fermat pow here
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v:
            out[i] = inv * pref[i] % P
            inv = inv * v % P
    return out


# Fq2 as (c0, c1) int tuples, always reduced mod p ------------------------


def _f2add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2neg(a):
    return (-a[0] % P, -a[1] % P)


def _f2mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def _f2sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def _f2sqrt_int(v):
    """Fq2 square root on int pairs, the oracle Fq2.sqrt complex method
    verbatim (same root choice); None iff the oracle returns None."""
    a, b = v
    if b == 0:
        s = O.fq_sqrt(a)
        if s is not None:
            return (s, 0)
        s = O.fq_sqrt(-a % P)
        if s is None:
            return None
        return (0, s)
    alpha = O.fq_sqrt((a * a + b * b) % P)
    if alpha is None:
        return None
    inv2 = (P + 1) // 2
    delta = (a + alpha) * inv2 % P
    x0 = O.fq_sqrt(delta)
    if x0 is None:
        delta = (a - alpha) % P * inv2 % P
        x0 = O.fq_sqrt(delta)
        if x0 is None:
            return None
    x1 = b * pow(2 * x0 % P, -1, P) % P
    cand = (x0, x1)
    if _f2sqr(cand) == v:
        return cand
    return None


# Jacobian point arithmetic (None is infinity), mirroring the oracle's
# ec_double / ec_add branch structure, so the U1 == U2 edge behavior
# (doubling / cancellation) is the oracle's.


def _j1_dbl(p):
    if p is None:
        return None
    X, Y, Z = p
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def _j1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 == S2:
            return _j1_dbl(p1)
        return None
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % P * H % P
    return (X3, Y3, Z3)


def _j2_dbl(p):
    if p is None:
        return None
    X, Y, Z = p
    A = _f2sqr(X)
    B = _f2sqr(Y)
    C = _f2sqr(B)
    t = _f2sqr(_f2add(X, B))
    D = _f2add(_f2sub(_f2sub(t, A), C), _f2sub(_f2sub(t, A), C))
    E = ((3 * A[0]) % P, (3 * A[1]) % P)
    X3 = _f2sub(_f2sqr(E), _f2add(D, D))
    C8 = ((8 * C[0]) % P, (8 * C[1]) % P)
    Y3 = _f2sub(_f2mul(E, _f2sub(D, X3)), C8)
    Z3 = _f2mul(_f2add(Y, Y), Z)
    return (X3, Y3, Z3)


def _j2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = _f2sqr(Z1)
    Z2Z2 = _f2sqr(Z2)
    U1 = _f2mul(X1, Z2Z2)
    U2 = _f2mul(X2, Z1Z1)
    S1 = _f2mul(_f2mul(Y1, Z2), Z2Z2)
    S2 = _f2mul(_f2mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return _j2_dbl(p1)
        return None
    H = _f2sub(U2, U1)
    I = _f2sqr(_f2add(H, H))
    J = _f2mul(H, I)
    rr = _f2add(_f2sub(S2, S1), _f2sub(S2, S1))
    V = _f2mul(U1, I)
    X3 = _f2sub(_f2sub(_f2sqr(rr), J), _f2add(V, V))
    SJ = _f2mul(S1, J)
    Y3 = _f2sub(_f2mul(rr, _f2sub(V, X3)), _f2add(SJ, SJ))
    Z3 = _f2mul(_f2sub(_f2sqr(_f2add(Z1, Z2)), _f2add(Z1Z1, Z2Z2)), H)
    return (X3, Y3, Z3)


def _j2_neg(p):
    if p is None:
        return None
    X, Y, Z = p
    return (X, _f2neg(Y), Z)


def _j2_mul(p, k: int):
    """LSB-first double-and-add, the oracle ec_mul schedule (k >= 0)."""
    result = None
    addend = p
    while k:
        if k & 1:
            result = _j2_add(result, addend)
        addend = _j2_dbl(addend)
        k >>= 1
    return result


def _j2_psi(p):
    """psi on Jacobian coords: conj is a field automorphism, so
    (X:Y:Z) -> (cx conj(X) : cy conj(Y) : conj(Z)) descends from the
    affine map (x, y) -> (cx conj(x), cy conj(y))."""
    if p is None:
        return None
    X, Y, Z = p
    return (
        _f2mul(_PSI_CX_T, (X[0], -X[1] % P)),
        _f2mul(_PSI_CY_T, (Y[0], -Y[1] % P)),
        (Z[0], -Z[1] % P),
    )


def _j1_mul(p, k: int):
    result = None
    addend = p
    while k:
        if k & 1:
            result = _j1_add(result, addend)
        addend = _j1_dbl(addend)
        k >>= 1
    return result


# beta: the primitive cube root of unity in Fq whose GLV endomorphism
# phi(x, y) = (beta*x, y) acts as [-z^2] on G1 (z = |BLS parameter|;
# checked against the generator in tests/test_torch_codec_batch.py)
_BETA_G1 = 0x5F19672FDF76CE51BA69C6076A0F77EADDB3A93BE6F89688DE17D813620A00022E01FFFFFFFEFFFE


def _g1_subgroup_host(pts: Sequence[Tuple[int, int]]) -> List[bool]:
    """GLV-endomorphism membership test on raw-int Jacobian ladders:
    P (on curve) is in G1 iff phi(P) == [-z^2]P, [z^2]P computed as two
    64-bit ladders [z]([z]P); the same verdict as the definitional [r]P
    ladder on EVERY curve point (phi^2 + phi + 1 == 0 holds identically
    on a j=0 curve, so phi(P) = [-z^2]P forces [r]P = O)."""
    out = []
    for x, y in pts:
        q = _j1_mul(_j1_mul((x, y, 1), _X_ABS), _X_ABS)
        if q is None:
            # ord(P) | z^2 and gcd(r, z^2) == 1: only infinity satisfies
            # both, so a finite P is a non-member
            out.append(False)
            continue
        Xq, Yq, Zq = q
        z2 = Zq * Zq % P
        z3 = z2 * Zq % P
        out.append(
            _BETA_G1 * x % P * z2 % P == Xq and (P - y) * z3 % P == Yq
        )
    return out


def _g2_subgroup_host(pts) -> List[bool]:
    """psi criterion on raw-int Jacobian: P in G2 iff psi(P) == -[|x|]P
    (the oracle is_in_g2_subgroup identity), compared cross-multiplied so
    no inversion is needed."""
    out = []
    for x, y in pts:
        q = _j2_mul((x, y, _ONE_T), _X_ABS)
        if q is None:
            out.append(False)  # psi of a finite point is finite
            continue
        px = _f2mul(_PSI_CX_T, (x[0], -x[1] % P))
        py = _f2mul(_PSI_CY_T, (y[0], -y[1] % P))
        Xq, Yq, Zq = q
        z2 = _f2sqr(Zq)
        z3 = _f2mul(z2, Zq)
        out.append(
            _f2mul(px, z2) == Xq and _f2mul(py, z3) == _f2neg(Yq)
        )
    return out


def _decompress_g1_int(raw: bytes, sign_large: bool):
    """48 flag-stripped bytes -> (x, y) ints or the oracle's ValueError."""
    x = int.from_bytes(raw, "big")
    if x >= P:
        return ValueError("G1 x out of range")
    y2 = (x * x % P * x + 4) % P
    y = O.fq_sqrt(y2)
    if y is None:
        return ValueError("G1 x not on curve")
    if sign_large != (y > _HALF_INT):
        y = P - y
    return (x, y)


def _decompress_g2_int(raw1: bytes, raw0: bytes, sign_large: bool):
    """x.c1 / x.c0 bytes -> ((x0,x1), (y0,y1)) ints or the ValueError."""
    x1 = int.from_bytes(raw1, "big")
    x0 = int.from_bytes(raw0, "big")
    if x0 >= P or x1 >= P:
        return ValueError("G2 x out of range")
    x = (x0, x1)
    y2 = _f2add(_f2mul(_f2sqr(x), x), (4, 4))
    y = _f2sqrt_int(y2)
    if y is None:
        return ValueError("G2 x not on curve")
    is_large = y[1] > _HALF_INT or (y[1] == 0 and y[0] > _HALF_INT)
    if sign_large != is_large:
        y = _f2neg(y)
    return (x, y)


# SSWU / iso-map constants as int pairs (from the oracle's Fq2 objects)
def _t2(v: "O.Fq2") -> Tuple[int, int]:
    return (v.c0, v.c1)


_NEG_B_OVER_A_T = _t2((-O.SSWU_B) * O.SSWU_A.inverse())
_X1_EXC_T = _t2(O.SSWU_B * (O.SSWU_Z * O.SSWU_A).inverse())
_SSWU_A_T = _t2(O.SSWU_A)
_SSWU_B_T = _t2(O.SSWU_B)
_SSWU_Z_T = _t2(O.SSWU_Z)
_ISO_X_NUM_T = [_t2(c) for c in O.ISO_X_NUM]
_ISO_X_DEN_T = [_t2(c) for c in O.ISO_X_DEN]
_ISO_Y_NUM_T = [_t2(c) for c in O.ISO_Y_NUM]
_ISO_Y_DEN_T = [_t2(c) for c in O.ISO_Y_DEN]


def _sgn0_t(v) -> int:
    return (v[0] % 2) or ((v[0] == 0) and (v[1] % 2))


def _horner_t(coeffs, x):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = _f2add(_f2mul(acc, x), c)
    return acc


def _gprime_t(x):
    x3 = _f2mul(_f2sqr(x), x)
    return _f2add(_f2add(x3, _f2mul(_SSWU_A_T, x)), _SSWU_B_T)


def _hash_to_g2_host(messages: Sequence[bytes], dst: bytes):
    """Batched hash_to_g2 on raw ints: batched SHA for the XMD stage,
    inline sqrts for SSWU (data-dependent), and ONE int_batch_inverse
    ladder each for the SSWU 1/tv2 divisions, the iso-map denominators,
    and the final Jacobian -> affine conversion. Returns affine
    ((x0,x1),(y0,y1)) int pairs, oracle-identical."""
    n = len(messages)
    us = []  # 2n field draws, msg-major: [m0.u0, m0.u1, m1.u0, ...]
    len_in_bytes = 2 * 2 * O.L_FIELD
    for u in expand_message_xmd_batch(messages, dst, len_in_bytes):
        for c in range(2):
            off = O.L_FIELD * 2 * c
            us.append((
                int.from_bytes(u[off : off + O.L_FIELD], "big") % P,
                int.from_bytes(u[off + O.L_FIELD : off + 2 * O.L_FIELD],
                               "big") % P,
            ))
    # SSWU phase 1: tv1/tv2 for every draw, 1/tv2 through one ladder
    # (Fq2 inverse = conj/norm; tv2 == 0 lanes take the exceptional x1)
    tv1s, tv2s = [], []
    for u in us:
        tv1 = _f2mul(_SSWU_Z_T, _f2sqr(u))
        tv1s.append(tv1)
        tv2s.append(_f2add(_f2sqr(tv1), tv1))
    ninv = int_batch_inverse(
        [(t[0] * t[0] + t[1] * t[1]) % P for t in tv2s]
    )
    qs = []
    for u, tv1, tv2, ni in zip(us, tv1s, tv2s, ninv):
        if tv2 == (0, 0):
            x1 = _X1_EXC_T
        else:
            inv_tv2 = (tv2[0] * ni % P, -tv2[1] * ni % P)
            x1 = _f2mul(_NEG_B_OVER_A_T, _f2add(_ONE_T, inv_tv2))
        gx1 = _gprime_t(x1)
        y = _f2sqrt_int(gx1)
        if y is not None:
            x = x1
        else:
            x = _f2mul(tv1, x1)
            y = _f2sqrt_int(_gprime_t(x))
            if y is None:  # cannot happen for valid parameters
                raise ValueError("SSWU: no square root found")
        if _sgn0_t(u) != _sgn0_t(y):
            y = _f2neg(y)
        qs.append((x, y))
    # iso map: denominators of every draw through one ladder (x_den and
    # y_den interleaved)
    dens = []
    nums = []
    for x, y in qs:
        xd = _horner_t(_ISO_X_DEN_T, x)
        yd = _horner_t(_ISO_Y_DEN_T, x)
        nums.append((_horner_t(_ISO_X_NUM_T, x),
                     _f2mul(y, _horner_t(_ISO_Y_NUM_T, x))))
        dens.extend([xd, yd])
    dinv = int_batch_inverse([(d[0] * d[0] + d[1] * d[1]) % P for d in dens])
    iso = []
    for j, (xn, yn) in enumerate(nums):
        xd, yd = dens[2 * j], dens[2 * j + 1]
        xdi = (xd[0] * dinv[2 * j] % P, -xd[1] * dinv[2 * j] % P)
        ydi = (yd[0] * dinv[2 * j + 1] % P, -yd[1] * dinv[2 * j + 1] % P)
        iso.append((_f2mul(xn, xdi), _f2mul(yn, ydi)))
    # add + clear cofactor (Budroni-Pintore psi decomposition, the oracle's
    # clear_cofactor_g2 schedule) on Jacobian ints
    accs = []
    for i in range(n):
        (x0, y0), (x1, y1) = iso[2 * i], iso[2 * i + 1]
        r = _j2_add((x0, y0, _ONE_T), (x1, y1, _ONE_T))
        t1 = _j2_mul(r, _X_ABS)            # [-x]P
        txx = _j2_mul(t1, _X_ABS)          # [x^2]P
        psi_p = _j2_psi(r)
        t2 = _j2_mul(psi_p, _X_ABS)        # [-x]psi(P)
        psi2_2p = _j2_psi(_j2_psi(_j2_dbl(r)))
        acc = _j2_add(txx, t1)
        acc = _j2_add(acc, _j2_neg(r))
        acc = _j2_add(acc, _j2_neg(t2))
        acc = _j2_add(acc, _j2_neg(psi_p))
        acc = _j2_add(acc, psi2_2p)
        if acc is None:  # not reachable: hash outputs are never infinity
            raise ValueError("hash_to_g2: point at infinity")
        accs.append(acc)
    # batched Jacobian -> affine: one ladder inverts every Z norm
    zinv = int_batch_inverse(
        [(z[0] * z[0] + z[1] * z[1]) % P for (_, _, z) in accs]
    )
    out = []
    for (X, Y, Z), ni in zip(accs, zinv):
        zi = (Z[0] * ni % P, -Z[1] * ni % P)
        zi2 = _f2sqr(zi)
        out.append((_f2mul(X, zi2), _f2mul(Y, _f2mul(zi2, zi))))
    return out


# ---------------------------------------------------------------------------
# batched decompression (ZCash format), oracle-exact rejection rules
# ---------------------------------------------------------------------------


def _parse_g1(blobs: Sequence[bytes]):
    """Shared flag/length validation for 48-byte compressed G1 blobs.
    Returns (res, live, raw_bytes, flags_sign): res pre-filled with the
    oracle's exact ValueErrors / None-for-infinity; live holds the indices
    whose x field still needs field math (either path)."""
    n = len(blobs)
    res: List[object] = [None] * n
    live: List[int] = []
    raw_bytes: List[bytes] = []
    flags_sign: List[bool] = []
    for i, data in enumerate(blobs):
        data = bytes(data)
        if len(data) != 48:
            res[i] = ValueError("G1 point must be 48 bytes")
            continue
        flags = data[0]
        if not (flags & O.FLAG_COMPRESSED):
            res[i] = ValueError("uncompressed G1 encoding not supported")
            continue
        if flags & O.FLAG_INFINITY:
            if (flags & O.FLAG_SIGN) or any(
                b for b in bytes([data[0] & 0x1F]) + data[1:]
            ):
                res[i] = ValueError("invalid infinity encoding")
            # else: infinity -> None, already the default
            continue
        live.append(i)
        raw_bytes.append(bytes([data[0] & 0x1F]) + data[1:])
        flags_sign.append(bool(flags & O.FLAG_SIGN))
    return res, live, raw_bytes, flags_sign


def decompress_g1_batch(blobs: Sequence[bytes], device=None) -> List[object]:
    """Per item: (x_limbs, y_limbs) canonical Montgomery, None (infinity),
    or the exact ValueError the oracle g1_from_bytes raises."""
    dev = resolve_device(device)
    res, live, raw_bytes, flags_sign = _parse_g1(blobs)
    if not live:
        return res
    if not _use_device(dev):
        for i, raw, sign in zip(live, raw_bytes, flags_sign):
            v = _decompress_g1_int(raw, sign)
            res[i] = v if isinstance(v, ValueError) else (
                fq.to_mont_int(v[0]), fq.to_mont_int(v[1])
            )
        return res
    arr = np.frombuffer(b"".join(raw_bytes), dtype=np.uint8).reshape(-1, 48)
    x_raw = bytes_be_to_limbs(arr)
    in_range = _limbs_lt_const(x_raw, _P_LIMBS)
    outs = _g1_decode(fq.limbs_from_numpy(
        _pad_batch(np.where(in_range[:, None], x_raw, 0)), dev))
    m = len(live)
    x, y, yneg, y_raw, on_curve = (_to_numpy(t)[:m] for t in outs)
    want_large = np.asarray(flags_sign)
    is_large = _sign_is_large_fq(y_raw)
    y_final = np.where((is_large != want_large)[:, None], yneg, y)
    for j, i in enumerate(live):
        if not in_range[j]:
            res[i] = ValueError("G1 x out of range")
        elif not on_curve[j]:
            res[i] = ValueError("G1 x not on curve")
        else:
            res[i] = (x[j], y_final[j])
    return res


def _parse_g2(blobs: Sequence[bytes]):
    """Shared flag/length validation for 96-byte compressed G2 blobs
    (see _parse_g1)."""
    n = len(blobs)
    res: List[object] = [None] * n
    live: List[int] = []
    raw1: List[bytes] = []  # x.c1 (first 48 bytes, flags stripped)
    raw0: List[bytes] = []  # x.c0
    flags_sign: List[bool] = []
    for i, data in enumerate(blobs):
        data = bytes(data)
        if len(data) != 96:
            res[i] = ValueError("G2 point must be 96 bytes")
            continue
        flags = data[0]
        if not (flags & O.FLAG_COMPRESSED):
            res[i] = ValueError("uncompressed G2 encoding not supported")
            continue
        if flags & O.FLAG_INFINITY:
            if (flags & O.FLAG_SIGN) or any(
                bytes([data[0] & 0x1F]) + data[1:]
            ):
                res[i] = ValueError("invalid infinity encoding")
            continue
        live.append(i)
        raw1.append(bytes([data[0] & 0x1F]) + data[1:48])
        raw0.append(data[48:])
        flags_sign.append(bool(flags & O.FLAG_SIGN))
    return res, live, raw1, raw0, flags_sign


def decompress_g2_batch(blobs: Sequence[bytes], device=None) -> List[object]:
    """Per item: (4, L) canonical [x.0, x.1, y.0, y.1] limb stack, None
    (infinity), or the exact ValueError the oracle g2_from_bytes raises."""
    dev = resolve_device(device)
    res, live, raw1, raw0, flags_sign = _parse_g2(blobs)
    if not live:
        return res
    if not _use_device(dev):
        for i, r1, r0, sign in zip(live, raw1, raw0, flags_sign):
            v = _decompress_g2_int(r1, r0, sign)
            res[i] = v if isinstance(v, ValueError) else np.stack(
                [fq.to_mont_int(v[0][0]), fq.to_mont_int(v[0][1]),
                 fq.to_mont_int(v[1][0]), fq.to_mont_int(v[1][1])]
            )
        return res
    a1 = bytes_be_to_limbs(
        np.frombuffer(b"".join(raw1), dtype=np.uint8).reshape(-1, 48)
    )
    a0 = bytes_be_to_limbs(
        np.frombuffer(b"".join(raw0), dtype=np.uint8).reshape(-1, 48)
    )
    in_range = _limbs_lt_const(a0, _P_LIMBS) & _limbs_lt_const(a1, _P_LIMBS)
    x_raw = np.stack([a0, a1], axis=1)  # (M, 2, L)
    x_raw = np.where(in_range[:, None, None], x_raw, 0)
    outs = _g2_decode(fq.limbs_from_numpy(_pad_batch(x_raw), dev))
    m = len(live)
    x, y, yneg, y_raw, on_curve = (_to_numpy(t)[:m] for t in outs)
    want_large = np.asarray(flags_sign)
    is_large = _sign_is_large_fq2(y_raw)
    y_final = np.where((is_large != want_large)[:, None, None], yneg, y)
    for j, i in enumerate(live):
        if not in_range[j]:
            res[i] = ValueError("G2 x out of range")
        elif not on_curve[j]:
            res[i] = ValueError("G2 x not on curve")
        else:
            res[i] = np.concatenate([x[j], y_final[j]], axis=0)
    return res


# ---------------------------------------------------------------------------
# backend-facing batch codecs (mirror bls_backend's per-item compute fns)
# ---------------------------------------------------------------------------


def pubkey_limbs_batch(pubkeys: Sequence[bytes], device=None,
                       mesh=None) -> List[object]:
    """Batched _pubkey_limbs_compute: per item (x_limbs, y_limbs) or a
    ValueError VALUE (the same messages as the per-item oracle path).
    ``mesh`` shards the subgroup check's rows."""
    dev = torch_env.resolve(device, mesh)
    res = decompress_g1_batch(pubkeys, dev)
    live = [i for i, v in enumerate(res) if isinstance(v, tuple)]
    for i, v in enumerate(res):
        if v is None:
            res[i] = ValueError("pubkey is the point at infinity")
    if live:
        pts = np.stack([np.stack(res[i]) for i in live])
        ok = g1_subgroup_check_batch(pts, dev, mesh=mesh)
        for j, i in enumerate(live):
            if not ok[j]:
                res[i] = ValueError("pubkey not in G1 subgroup")
    return res


def signature_limbs_batch(signatures: Sequence[bytes], device=None,
                          mesh=None) -> List[object]:
    """Batched _signature_limbs_compute: per item a (4, L) limb stack or a
    ValueError VALUE (decode errors included, uniformly as values).
    ``mesh`` shards the subgroup check's rows."""
    dev = torch_env.resolve(device, mesh)
    res = decompress_g2_batch(signatures, dev)
    live = [i for i, v in enumerate(res) if isinstance(v, np.ndarray)]
    for i, v in enumerate(res):
        if v is None:
            res[i] = ValueError("signature is the point at infinity")
    if live:
        pts = np.stack([res[i] for i in live])
        ok = g2_subgroup_check_batch(pts, dev, mesh=mesh)
        for j, i in enumerate(live):
            if not ok[j]:
                res[i] = ValueError("signature not in G2 subgroup")
    return res


def message_limbs_batch(messages: Sequence[bytes], dst: bytes,
                        device=None, mesh=None) -> List[np.ndarray]:
    """Batched _message_limbs_compute: per message the (4, L) canonical
    affine hash-to-G2 limb stack (``mesh`` shards the finishing
    program's rows)."""
    pts = hash_to_g2_batch(messages, dst, device, mesh=mesh)
    return [pts[i] for i in range(pts.shape[0])]
