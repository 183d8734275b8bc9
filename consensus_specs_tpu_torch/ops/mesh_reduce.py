"""Cross-slot G1 aggregation-tree reduction (the port's counterpart of
consensus_specs_tpu/ops/mesh_reduce.py).

The protocol's aggregation trees (committee signatures -> aggregator ->
block; pubkey aggregation per verify, reference specs/altair/bls.md:
33-57) map onto the mesh as a REDUCTION across its slots: each slot folds
its local shard of the key set with branchless complete additions, then a
log2(n)-round XOR butterfly (``mesh_rlc.butterfly_reduce``) exchanges
partial sums between slots, a psum with the G1 group law as the monoid.
The local fold is one launch of csrc/g1_fold.cu a slot on the card
(``cuda_tower.g1_fold``, the JAX package's per-device ``lax.scan``;
``_local_fold_plain`` on the CPU); in the butterfly every Fq product is
one ``fq.mont_mul`` (kernel 2 on the card).

Point representation: projective (X:Y:Z) Montgomery limb tensors
(..., 3, 15); infinity = (0:1:0). The Renes-Costello-Batina complete
addition (2016, algorithm 7 for a=0, b=4) is branchless and
infinity-safe, so padding lanes and identity folds need no special cases.
The fold starts from infinity and adds every point (``inf + P`` is
computed, not skipped), in the JAX package's operand order, so the limbs
are the JAX package's; the affine result is the host oracle's
``eth_aggregate_pubkeys`` point sum.
"""
from typing import Sequence

import numpy as np
import torch

from ..utils import bls12_381 as O
from . import cuda_tower, fq
from .mesh_rlc import _mesh_reduce

_B3 = 12  # 3*b for y^2 = x^3 + 4


def g1_complete_add(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """RCB complete projective addition; operands and result are
    (..., 3, 15) loose Montgomery limb tensors."""
    X1, Y1, Z1 = p1[..., 0, :], p1[..., 1, :], p1[..., 2, :]
    X2, Y2, Z2 = p2[..., 0, :], p2[..., 1, :], p2[..., 2, :]
    b3 = fq.limbs_from_numpy(fq.to_mont_int(_B3), p1.device)

    t0 = fq.mont_mul(X1, X2)
    t1 = fq.mont_mul(Y1, Y2)
    t2 = fq.mont_mul(Z1, Z2)
    t3 = fq.mont_mul(fq.add(X1, Y1), fq.add(X2, Y2))
    t3 = fq.sub(t3, fq.add(t0, t1))
    t4 = fq.mont_mul(fq.add(Y1, Z1), fq.add(Y2, Z2))
    t4 = fq.sub(t4, fq.add(t1, t2))
    X3 = fq.mont_mul(fq.add(X1, Z1), fq.add(X2, Z2))
    Y3 = fq.sub(X3, fq.add(t0, t2))
    X3 = fq.add(t0, t0)
    t0 = fq.add(X3, t0)
    t2 = fq.mont_mul(b3, t2)
    Z3 = fq.add(t1, t2)
    t1 = fq.sub(t1, t2)
    Y3 = fq.mont_mul(b3, Y3)
    X3 = fq.mont_mul(t4, Y3)
    t2 = fq.mont_mul(t3, t1)
    X3 = fq.sub(t2, X3)
    Y3 = fq.mont_mul(Y3, t0)
    t1 = fq.mont_mul(t1, Z3)
    Y3 = fq.add(t1, Y3)
    t0 = fq.mont_mul(t0, t3)
    Z3 = fq.mont_mul(Z3, t4)
    Z3 = fq.add(Z3, t0)
    return torch.stack([X3, Y3, Z3], dim=-2)


def infinity_point(batch_shape=()) -> np.ndarray:
    out = np.zeros(tuple(batch_shape) + (3, fq.NUM_LIMBS), dtype=np.uint64)
    out[..., 1, :] = fq.to_mont_int(1)
    return out


def _local_fold(points: torch.Tensor) -> torch.Tensor:
    """Sequential fold of a slot-local (k, 3, L) shard, from infinity: one
    launch of csrc/g1_fold.cu on the card, ``_local_fold_plain`` on the
    CPU."""
    if points.is_cuda:
        return cuda_tower.g1_fold(points)
    return _local_fold_plain(points)


def _local_fold_plain(points: torch.Tensor) -> torch.Tensor:
    """Sequential fold of a slot-local (k, 3, L) shard, from infinity
    (inf + P_0 computed, as the JAX scan computes it)."""
    acc = fq.limbs_from_numpy(infinity_point(), points.device)
    for i in range(points.shape[0]):
        acc = g1_complete_add(acc, points[i])
    return acc


def mesh_aggregate_g1(points: np.ndarray, mesh) -> np.ndarray:
    """Sum a (k, 3, L) batch of projective G1 points over the mesh's
    slots: a local fold a slot, then the butterfly. Returns one (3, L)
    point, slot 0's value (the JAX package's device-0 replica)."""
    return _mesh_reduce(np.asarray(points, dtype=np.uint64),
                        infinity_point((mesh.size,)), mesh, _local_fold,
                        g1_complete_add)


def aggregate_pubkeys(pubkeys: Sequence[bytes], mesh) -> bytes:
    """Device-path ``eth_aggregate_pubkeys`` (reference specs/altair/
    bls.md:33-57): decode and validate on the host, sum on the mesh,
    re-encode. Raises on invalid or infinity pubkeys exactly like the
    oracle."""
    from .bls_backend import _pubkey_limbs

    if len(pubkeys) == 0:
        raise ValueError("no pubkeys to aggregate")
    pts = np.zeros((len(pubkeys), 3, fq.NUM_LIMBS), dtype=np.uint64)
    one = fq.to_mont_int(1)
    for i, pk in enumerate(pubkeys):
        x, y = _pubkey_limbs(bytes(pk))
        pts[i, 0], pts[i, 1], pts[i, 2] = x, y, one
    agg = mesh_aggregate_g1(pts, mesh)
    x, y, z = (fq.from_mont_limbs(agg[i]) for i in range(3))
    if z == 0:
        # e.g. [P, -P]: the oracle encodes the infinity aggregate rather
        # than raising (utils/bls12_381.py g1_to_bytes(None))
        return O.g1_to_bytes(None)
    zinv = pow(z, -1, O.P)
    aff = (O.Fq(x * zinv % O.P), O.Fq(y * zinv % O.P))
    return O.g1_to_bytes(aff)
