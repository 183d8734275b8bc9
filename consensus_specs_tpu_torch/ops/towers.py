"""Fq2 and Fq12 tower arithmetic over the limb base field (ops/fq.py): the
counterpart of consensus_specs_tpu/ops/towers.py, limb for limb.

Fq2 = Fq[u]/(u^2 + 1), shape (..., 2, 15) int64 limbs.

Fq12 is FLAT: Fq[w]/(w^12 - 2w^6 + 2), shape (..., 12, 15) int64 limbs
(w^6 = 1 + u = xi, so the field is the oracle's 2-3-2 tower in another
basis). An Fq12 product is ONE batched 144-way ``fq.mont_mul`` (the CUDA
kernel on the card) plus column sums and the w^12 = 2w^6 - 2 reduction.

Every operation is elementwise over the batch, so where the JAX package
makes several independent products or subtractions one after another,
Frobenius, the inversion and the component views stack them into one
call: each element sees the same operations, so the limbs are the JAX
package's, in fewer kernel launches. Constants built
from numpy take an explicit ``device``. Host converters map oracle tower
elements to and from w-basis limb tensors.
"""
import numpy as np
import torch

from ..utils.bls12_381 import Fq2 as OFq2
from ..utils.bls12_381 import Fq6 as OFq6
from ..utils.bls12_381 import Fq12 as OFq12
from ..utils.bls12_381 import P
from . import fq


def fq2_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fq.add(a, b)


def fq2_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fq.sub(a, b)


def fq2_neg(a: torch.Tensor) -> torch.Tensor:
    return fq.neg(a)


def fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    t0 = fq.mont_mul(a0, b0)
    t1 = fq.mont_mul(a1, b1)
    t2 = fq.mont_mul(fq.add(a0, a1), fq.add(b0, b1))
    c0 = fq.sub(t0, t1)
    c1 = fq.sub(t2, fq.add(t0, t1))
    return torch.stack([c0, c1], dim=-2)


def fq2_square(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = a[..., 0, :], a[..., 1, :]
    c0 = fq.mont_mul(fq.add(a0, a1), fq.sub(a0, a1))
    c1 = fq.mont_mul(a0, a1)
    c1 = fq.add(c1, c1)
    return torch.stack([c0, c1], dim=-2)


def fq2_mul_scalar(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply Fq2 by an Fq scalar (shape (..., 15))."""
    return fq.mont_mul(a, s[..., None, :])


def fq2_canonical(a: torch.Tensor) -> torch.Tensor:
    return fq.canonical(a)


def fq2_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (fq.canonical(a) == 0).all(dim=-1).all(dim=-1)


def fq2_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (fq.canonical(a) == fq.canonical(b)).all(dim=-1).all(dim=-1)


def fq2_select(cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None, None], a, b)


def fq2_double(a: torch.Tensor) -> torch.Tensor:
    return fq.add(a, a)


def fq2_const(c0_int: int, c1_int: int, batch_shape=(), *,
              device) -> torch.Tensor:
    arr = np.stack([fq.to_mont_int(c0_int % P), fq.to_mont_int(c1_int % P)])
    c = torch.from_numpy(arr.astype(np.int64)).to(device)
    return c.expand(tuple(batch_shape) + (2, fq.NUM_LIMBS))


def fq2_from_oracle(x: OFq2, batch_shape=(), *, device) -> torch.Tensor:
    return fq2_const(x.c0, x.c1, batch_shape, device=device)


def _host(a) -> np.ndarray:
    """Limbs as a host array (a tensor on any device, or an array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def fq2_to_oracle(a) -> OFq2:
    a = _host(a)
    return OFq2(fq.from_mont_limbs(a[..., 0, :]),
                fq.from_mont_limbs(a[..., 1, :]))


def _fq2_mul_many(pairs):
    """fq2_mul over a list of (a, b) pairs of one batch shape, as ONE
    fq2_mul of the stacked pairs (the same operations on every element:
    the limbs of the products made one by one)."""
    lhs, rhs = zip(*pairs)
    lhs = torch.stack(torch.broadcast_tensors(*lhs))
    rhs = torch.stack(torch.broadcast_tensors(*rhs))
    return list(fq2_mul(*torch.broadcast_tensors(lhs, rhs)).unbind(0))


def fq12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b on (..., 12, 15) loose limbs.

    The JAX package sums each of the 23 product columns and carries it,
    then folds degrees 22..12 down one at a time (c2 = 2c into column
    k - 6, out of column k - 12). Here the columns are summed and carried
    together, and the fold runs in two batches: degrees 22..17 read only
    columns nothing writes before them, and degrees 16..12 read columns
    only the first batch writes. Every column sees the same adds and
    subtracts in the same order, so the limbs are the JAX package's."""
    prod = fq.mont_mul(a[..., :, None, :], b[..., None, :, :])  # (...,12,12,L)
    acc = prod.new_zeros(prod.shape[:-3] + (23, fq.NUM_LIMBS))
    for i in range(12):
        acc[..., i : i + 12, :] += prod[..., i, :, :]  # raw sums, <= 12 terms
    cols = fq._carry_limbs(acc)
    c2 = fq.add(cols[..., 17:23, :], cols[..., 17:23, :])  # degrees 17..22
    cols[..., 11:17, :] = fq.add(cols[..., 11:17, :], c2)
    cols[..., 5:11, :] = fq.sub(cols[..., 5:11, :], c2)
    c2 = fq.add(cols[..., 12:17, :], cols[..., 12:17, :])  # degrees 12..16
    cols[..., 6:11, :] = fq.add(cols[..., 6:11, :], c2)
    cols[..., 0:5, :] = fq.sub(cols[..., 0:5, :], c2)
    return cols[..., :12, :]


def fq12_square(a: torch.Tensor) -> torch.Tensor:
    return fq12_mul(a, a)


def fq12_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fq.add(a, b)


def fq12_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fq.sub(a, b)


def fq12_conjugate(a: torch.Tensor) -> torch.Tensor:
    """x -> x^(p^6): negate the odd-degree w coefficients (one batched
    ``fq.neg`` over the six of them)."""
    out = a.clone()
    out[..., 1::2, :] = fq.neg(a[..., 1::2, :])
    return out


def fq12_one(batch_shape, device) -> torch.Tensor:
    arr = np.zeros((12, fq.NUM_LIMBS), dtype=np.int64)
    arr[0] = fq.ONE_MONT
    one = torch.from_numpy(arr).to(device)
    return one.expand(tuple(batch_shape) + (12, fq.NUM_LIMBS))


def fq12_is_one(a: torch.Tensor) -> torch.Tensor:
    one = fq12_one(a.shape[:-2], a.device)
    return (fq.canonical(a) == fq.canonical(one)).all(dim=-1).all(dim=-1)


def fq12_select(cond: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None, None], a, b)


def fq12_from_tower_components(c00: torch.Tensor, c11w: torch.Tensor,
                               c12w: torch.Tensor) -> torch.Tensor:
    """Flat Fq12 from Fq2 components at tower basis slots: c00 at 1, c11w
    at v*w (= w^3), c12w at v^2*w (= w^5). An Fq2 element a + b*u at w^k
    lands as a - b at w^k and b at w^(k+6); the other six coefficients
    are 0. (The JAX package adds each placed value to a zero column,
    which carries it; so does this.)"""
    comps = torch.stack(torch.broadcast_tensors(c00, c11w, c12w), dim=-3)
    a_, b_ = comps[..., 0, :], comps[..., 1, :]  # (..., 3, L)
    out = comps.new_zeros(comps.shape[:-3] + (12, fq.NUM_LIMBS))
    zero = torch.zeros_like(b_)
    out[..., [0, 3, 5], :] = fq.add(zero, fq.sub(a_, b_))
    out[..., [6, 9, 11], :] = fq.add(zero, b_)
    return out


# ---------------------------------------------------------------------------
# flat <-> Fq2-component view (w^k coefficients, k = 0..5)
#
# In the flat basis w^6 = xi = 1 + u, so a flat element is
#   sum_{k=0}^{5} (a_k + b_k u) w^k  with  a_k = flat[k] + flat[k+6],
#                                          b_k = flat[k+6].
# This view makes Frobenius and tower inversion expressible with fq2 ops.
# ---------------------------------------------------------------------------


def _to_components(a: torch.Tensor) -> torch.Tensor:
    """Flat (..., 12, L) -> (..., 6, 2, L): the Fq2 coefficients of
    w^0..w^5 along axis -3."""
    hi = a[..., 6:, :]
    return torch.stack([fq.add(a[..., :6, :], hi), hi], dim=-2)


def _from_components(c: torch.Tensor) -> torch.Tensor:
    """Inverse of _to_components."""
    return torch.cat([fq.sub(c[..., 0, :], c[..., 1, :]), c[..., 1, :]],
                     dim=-2)


def fq12_to_components(a: torch.Tensor):
    """Flat (..., 12, L) -> list of 6 Fq2 coefficients (..., 2, L) for
    w^0..w^5."""
    return list(_to_components(a).unbind(-3))


def fq12_from_components(comps) -> torch.Tensor:
    """Inverse of fq12_to_components."""
    return _from_components(torch.stack(torch.broadcast_tensors(*comps),
                                        dim=-3))


# Frobenius constants gamma[n][k] = xi^(k*(p^n-1)/6) as Fq2 ints (host once).
def _fq2_pow_int(base: OFq2, e: int) -> OFq2:
    acc = OFq2(1, 0)
    b = base
    while e:
        if e & 1:
            acc = acc * b
        b = b * b
        e >>= 1
    return acc


_XI = OFq2(1, 1)
_GAMMA = {
    n: [_fq2_pow_int(_XI, k * (P**n - 1) // 6) for k in range(6)]
    for n in (1, 2, 3)
}


def fq2_conjugate(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 0, :], fq.neg(a[..., 1, :])], dim=-2)


def _gamma(n: int, device):
    """(the components whose gamma[n][k] is not 1, their (m, 2, L)
    Montgomery constants): the JAX package multiplies those only."""
    ks = [k for k, g in enumerate(_GAMMA[n]) if (g.c0, g.c1) != (1, 0)]
    consts = np.stack([np.stack([fq.to_mont_int(_GAMMA[n][k].c0),
                                 fq.to_mont_int(_GAMMA[n][k].c1)])
                       for k in ks]).astype(np.int64)
    return ks, torch.from_numpy(consts).to(device)


def fq12_frobenius(a: torch.Tensor, n: int) -> torch.Tensor:
    """a^(p^n) for n in {1, 2, 3}: conjugate the Fq2 coefficients (n odd)
    and scale the w^k coefficient by xi^(k*(p^n-1)/6), the five scalings
    as one batched fq2_mul."""
    c = _to_components(a)
    if n % 2 == 1:
        c = fq2_conjugate(c)
    ks, g = _gamma(n, a.device)
    c = c.clone()
    c[..., ks, :, :] = fq2_mul(c[..., ks, :, :], g)
    return _from_components(c)


# ---------------------------------------------------------------------------
# inversion: tower formulas over the component view
# Fq6 = Fq2[v]/(v^3 - xi) with v = w^2; Fq12 = Fq6[w]/(w^2 - v).
# Components: e0 = (c0, c2, c4) (even w-powers = 1, v, v^2),
#             e1 = (c1, c3, c5) (odd  w-powers = w, vw, v^2 w).
# ---------------------------------------------------------------------------


def _fq2_mul_xi(a: torch.Tensor) -> torch.Tensor:
    """Multiply by xi = 1 + u: (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fq.sub(a0, a1), fq.add(a0, a1)], dim=-2)


def fq2_inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2); inv(0) == 0. The one
    Fq inversion is ``fq.inv`` (on the card one launch of the chain
    kernel, ``cuda_fq.pow_chain``)."""
    sq = fq.mont_mul(a, a)  # a0^2, a1^2 in one product
    di = fq.inv(fq.add(sq[..., 0, :], sq[..., 1, :]))
    t = fq.mont_mul(a, di[..., None, :])
    return torch.stack([t[..., 0, :], fq.neg(t[..., 1, :])], dim=-2)


def _fq6_mul(a, b):
    """Schoolbook Fq6 mul over component triples (tuples of Fq2): the nine
    Fq2 products as one batched fq2_mul."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    t00, t11, t22, t12, t21, t01, t10, t02, t20 = _fq2_mul_many(
        [(a0, b0), (a1, b1), (a2, b2), (a1, b2), (a2, b1), (a0, b1),
         (a1, b0), (a0, b2), (a2, b0)])
    c0 = fq2_add(t00, _fq2_mul_xi(fq2_add(t12, t21)))
    c1 = fq2_add(fq2_add(t01, t10), _fq2_mul_xi(t22))
    c2 = fq2_add(fq2_add(t02, t20), t11)
    return (c0, c1, c2)


def _fq6_mul_by_v(a):
    a0, a1, a2 = a
    return (_fq2_mul_xi(a2), a0, a1)


def _fq6_inv(a):
    a0, a1, a2 = a
    s00, s12, s22, s01, s11, s02 = _fq2_mul_many(
        [(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)])
    A = fq2_sub(s00, _fq2_mul_xi(s12))
    B = fq2_sub(_fq2_mul_xi(s22), s01)
    C = fq2_sub(s11, s02)
    f0, f2, f1 = _fq2_mul_many([(a0, A), (a2, B), (a1, C)])
    F = fq2_add(f0, _fq2_mul_xi(fq2_add(f2, f1)))
    Fi = fq2_inv(F)
    return tuple(_fq2_mul_many([(A, Fi), (B, Fi), (C, Fi)]))


def fq12_inv(a: torch.Tensor) -> torch.Tensor:
    """General Fq12 inversion (flat in/out) via the 2-3-2 tower; one Fq
    inversion in all, at the bottom. The two halves' Fq6 products run as
    one (each on its own batch slice)."""
    c = fq12_to_components(a)
    e = (torch.stack([c[0], c[1]]), torch.stack([c[2], c[3]]),
         torch.stack([c[4], c[5]]))  # (e0, e1) along a new axis 0
    sq = _fq6_mul(e, e)
    e0e0 = tuple(x[0] for x in sq)
    v_e1e1 = _fq6_mul_by_v(tuple(x[1] for x in sq))
    d = tuple(fq2_sub(x, y) for x, y in zip(e0e0, v_e1e1))
    di = _fq6_inv(d)
    o = _fq6_mul(e, tuple(x[None] for x in di))
    o0 = tuple(x[0] for x in o)
    o1 = tuple(fq2_neg(x[1]) for x in o)
    return fq12_from_components([o0[0], o1[0], o0[1], o1[1], o0[2], o1[2]])


def fq12_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (fq.canonical(a) == fq.canonical(b)).all(dim=-1).all(dim=-1)


# ---------------------------------------------------------------------------
# host conversions oracle tower <-> flat basis
# ---------------------------------------------------------------------------


def fq12_from_oracle(x: OFq12, batch_shape=(), *, device) -> torch.Tensor:
    """Tower (c0 + c1 v + c2 v^2) + (d0 + d1 v + d2 v^2) w -> w-basis
    coefficients."""
    coeffs = [0] * 12
    for half, fq6el in enumerate((x.c0, x.c1)):  # w^0 / w^1 halves
        for vi, fq2el in enumerate((fq6el.c0, fq6el.c1, fq6el.c2)):
            k = 2 * vi + half  # v^vi = w^(2 vi)
            a_, b_ = fq2el.c0, fq2el.c1
            coeffs[k] = (coeffs[k] + a_ - b_) % P
            coeffs[k + 6] = (coeffs[k + 6] + b_) % P
    arr = np.stack([fq.to_mont_int(c) for c in coeffs]).astype(np.int64)
    return torch.from_numpy(arr).to(device).expand(
        tuple(batch_shape) + (12, fq.NUM_LIMBS))


def fq12_to_oracle(a) -> OFq12:
    a = _host(a)
    coeffs = [fq.from_mont_limbs(a[..., k, :]) for k in range(12)]
    # invert the basis map: at slot k (k<6): value a-b, at k+6: b
    sixes = []
    for half in range(2):
        fq2s = []
        for vi in range(3):
            k = 2 * vi + half
            b_ = coeffs[k + 6]
            a_ = (coeffs[k] + b_) % P
            fq2s.append(OFq2(a_, b_))
        sixes.append(OFq6(*fq2s))
    return OFq12(sixes[0], sixes[1])
