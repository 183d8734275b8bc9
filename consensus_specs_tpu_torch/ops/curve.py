"""Jacobian curve arithmetic for G1 (over Fq) and G2 (over Fq2): the
counterpart of consensus_specs_tpu/ops/curve.py, limb for limb.

Points are dicts of coordinate tensors {x, y, z} (Jacobian; z == 0
encodes infinity), batched over leading dims. The formulas are
branchless: every special case of ``add_mixed`` is a select, so one call
serves a whole batch. Every Fq product is one ``fq.mont_mul`` (the CUDA
kernel on the card). The formulas are the oracle's
(utils/bls12_381.py ec_double / ec_add). ``scalar_mul_fixed`` on a CUDA
tensor is one launch of csrc/scalar_mul.cu (ops/cuda_tower.scalar_mul).
"""
import numpy as np
import torch

from . import cuda_tower, fq
from . import towers as tw

# field-op namespaces so the same formulas serve G1 (Fq) and G2 (Fq2)


class _FqOps:
    mul = staticmethod(fq.mont_mul)
    add = staticmethod(fq.add)
    sub = staticmethod(fq.sub)
    neg = staticmethod(fq.neg)
    is_zero = staticmethod(fq.is_zero)
    select = staticmethod(fq.select)

    @staticmethod
    def square(a):
        return fq.mont_mul(a, a)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)


class _Fq2Ops:
    mul = staticmethod(tw.fq2_mul)
    add = staticmethod(tw.fq2_add)
    sub = staticmethod(tw.fq2_sub)
    neg = staticmethod(tw.fq2_neg)
    square = staticmethod(tw.fq2_square)
    is_zero = staticmethod(tw.fq2_is_zero)
    select = staticmethod(tw.fq2_select)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)


FQ_OPS = _FqOps
FQ2_OPS = _Fq2Ops


def point(x, y, z):
    return {"x": x, "y": y, "z": z}


def point_select(F, cond, p1, p2):
    return {k: F.select(cond, p1[k], p2[k]) for k in ("x", "y", "z")}


def is_infinity(F, pt):
    return F.is_zero(pt["z"])


def double(F, pt):
    """Jacobian doubling, a = 0 (the oracle's ec_double). A point with
    Y == 0, or infinity, doubles to z == 0, since Z3 = 2YZ."""
    X, Y, Z = pt["x"], pt["y"], pt["z"]
    A = F.square(X)
    B = F.square(Y)
    C = F.square(B)
    t = F.add(X, B)
    t2 = F.sub(F.sub(F.square(t), A), C)
    D = F.add(t2, t2)
    E = F.add(F.add(A, A), A)
    Fv = F.square(E)
    X3 = F.sub(Fv, F.add(D, D))
    C8 = F.add(F.add(F.add(C, C), F.add(C, C)),
               F.add(F.add(C, C), F.add(C, C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    YZ = F.mul(Y, Z)
    Z3 = F.add(YZ, YZ)
    return point(X3, Y3, Z3)


def add_mixed(F, pt, qx, qy):
    """Jacobian + affine addition, branchless: pt at infinity -> Q; pt ==
    Q -> double; pt == -Q -> infinity."""
    X, Y, Z = pt["x"], pt["y"], pt["z"]
    Z2 = F.square(Z)
    Z3 = F.mul(Z2, Z)
    U2 = F.mul(qx, Z2)
    S2 = F.mul(qy, Z3)
    H = F.sub(U2, X)  # x difference
    R = F.sub(S2, Y)  # y difference
    H2 = F.square(H)
    H3 = F.mul(H2, H)
    V = F.mul(X, H2)
    R2 = F.square(R)
    X3 = F.sub(F.sub(R2, H3), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(Y, H3))
    Z3n = F.mul(Z, H)
    out = point(X3, Y3, Z3n)

    # special cases
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(R)
    # pt == Q: double instead
    dbl = double(F, pt)
    out = point_select(F, h_zero & r_zero, dbl, out)
    # pt == -Q: infinity (z = 0)
    inf_pt = point(F.zeros_like(X), F.zeros_like(Y), F.zeros_like(Z))
    out = point_select(F, h_zero & ~r_zero, inf_pt, out)
    # pt at infinity: Q (affine -> Jacobian with z = 1)
    one = _field_one(F, X)
    q_jac = point(qx, qy, one)
    out = point_select(F, is_infinity(F, pt), q_jac, out)
    return out


def _field_one(F, like):
    if F is FQ_OPS:
        return fq.const(1, like.shape[:-1], device=like.device)
    return tw.fq2_const(1, 0, like.shape[:-2], device=like.device)


def scalar_mul_fixed(F, qx, qy, scalar_bits):
    """(scalar)·Q for affine Q by double-and-add over the STATIC msb-first
    bit list ``scalar_bits``; returns a Jacobian point. On a CUDA tensor
    the whole loop is one launch of csrc/scalar_mul.cu
    (``cuda_tower.scalar_mul``, which raises rather than fall back);
    elsewhere ``scalar_mul_fixed_plain``."""
    if qx.device.type == "cuda":
        return cuda_tower.scalar_mul(qx, qy, scalar_bits, g2=F is FQ2_OPS)
    return scalar_mul_fixed_plain(F, qx, qy, scalar_bits)


def scalar_mul_fixed_plain(F, qx, qy, scalar_bits):
    """The loop of ``scalar_mul_fixed``, product by product. The JAX
    package's ``lax.scan`` becomes a loop over the bits: each bit doubles,
    and a set bit takes the mixed addition (the select's other side, kept
    on a clear bit, is the doubled point itself), so the limbs are the JAX
    package's."""
    acc = point(F.zeros_like(qx), F.zeros_like(qy), torch.zeros_like(qx))
    for bit in scalar_bits:
        acc = double(F, acc)
        if bit:
            acc = add_mixed(F, acc, qx, qy)
    return acc


def subgroup_check_bits():
    """MSB-first bits of the curve order r."""
    from ..utils.bls12_381 import R

    return [int(b) for b in bin(R)[2:]]


def affine_limbs(points):
    """(x, y) Montgomery limbs, int64 numpy arrays, of affine points as
    utils/bls12_381 holds them: G1 points give rows of (15,), G2 points
    rows of (2, 15)."""
    def enc(v):
        if hasattr(v, "c0"):
            return np.stack([fq.to_mont_int(v.c0), fq.to_mont_int(v.c1)])
        return fq.to_mont_int(v.n)
    return tuple(np.stack([enc(p[i]) for p in points]).astype(np.int64)
                 for i in (0, 1))
