"""Fq2 and Fq12 tower arithmetic over the limb base field (ops/fq.py): the
subset of consensus_specs_tpu/ops/towers.py that the codec and the RLC
combine run, limb for limb.

Fq2 = Fq[u]/(u^2 + 1), shape (..., 2, 15) int64 limbs.

Fq12 is FLAT: Fq[w]/(w^12 - 2w^6 + 2), shape (..., 12, 15) int64 limbs
(w^6 = 1 + u = xi, so the field is the oracle's 2-3-2 tower in another
basis). An Fq12 product is ONE batched 144-way ``fq.mont_mul`` (the CUDA
kernel on the card) plus column sums and the w^12 = 2w^6 - 2 reduction.
"""
import numpy as np
import torch

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


def fq2_canonical(a: torch.Tensor) -> torch.Tensor:
    return fq.canonical(a)


def fq2_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (fq.canonical(a) == 0).all(dim=-1).all(dim=-1)


def fq2_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (fq.canonical(a) == fq.canonical(b)).all(dim=-1).all(dim=-1)


def fq2_select(cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None, None], a, b)


def fq2_const(c0_int: int, c1_int: int, batch_shape=(), *,
              device) -> torch.Tensor:
    arr = np.stack([fq.to_mont_int(c0_int % P), fq.to_mont_int(c1_int % P)])
    c = torch.from_numpy(arr.astype(np.int64)).to(device)
    return c.expand(tuple(batch_shape) + (2, fq.NUM_LIMBS))


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


def fq12_one(batch_shape, device) -> torch.Tensor:
    arr = np.zeros((12, fq.NUM_LIMBS), dtype=np.int64)
    arr[0] = fq.ONE_MONT
    one = torch.from_numpy(arr).to(device)
    return one.expand(tuple(batch_shape) + (12, fq.NUM_LIMBS))


def fq12_select(cond: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None, None], a, b)
