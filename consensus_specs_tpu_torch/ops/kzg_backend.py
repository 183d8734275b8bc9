"""Batched KZG point-proof verification (BASELINE config #5): the port's
copy of the JAX package's ops/kzg_backend.py, on the port's VM.

The sharding/DAS draft's sample verification is a KZG pairing check per
sample (reference specs/sharding/beacon-chain.md:717-721 for the degree
check; das-core.md:132-182 for sample multiproofs). The oracle side lives
in utils/kzg.py; THIS module runs N independent point-proof checks through
the same field-ALU VM pipeline the BLS backend uses: one batched 2-pairing
product per check.

Equation mapping. The oracle checks

    e(C - [y]G1, G2) == e(pi, [tau - z]G2)            (verify_point_proof)

The VM's AggregateVerify program computes prod_j e(pk_j, h_j) * e(-g1, sig)
(ops/vmlib.py). Choosing

    pk0 = pi,              h0  = [tau - z]G2
    pk1 = [y]G1 - C + G1,  h1  = G2 generator
    sig = G2 generator

makes the program's product equal e(pi, [tau-z]G2) * e([y]G1 - C, G2) —
exactly the check, == 1 iff the proof verifies (the +G1 term cancels the
program's fixed e(-g1, sig) factor). Infinity pk lanes are absorbed by the
program's complete additions, so a proof/commitment edge case degrades to
the mathematically-correct subcheck instead of crashing.

Device stages: PROG A (``aggregate_verify`` k=2) in one ``vm.execute``,
the host easy part, then the hard part (``_run_hard_part``): on the card
both executions are one launch each of the step kernel
(``csrc/vm_step.cu``); ``device="cpu"`` runs the plain steps. The host prep
(a G2 and a G1 scalar multiplication per item) is the exact-int oracle's.
"""
from typing import Sequence

import numpy as np

from ..utils import bls12_381 as O
from ..utils import torch_env
from . import fq, vm
from .bls_backend import (
    _G2GEN_LIMBS,
    _G2_COMPS,
    _INF_G1,
    _ONE_LIMBS,
    _easy_part_flat,
    _FoldLayout,
    _run_hard_part,
)


def _g1_limbs(pt):
    """Oracle G1 point (jacobian/None) -> projective Montgomery limbs;
    infinity -> (0:1:0)."""
    aff = O.ec_to_affine(pt)
    if aff is None:
        return _INF_G1[0], _INF_G1[1], _INF_G1[2]
    return (
        fq.to_mont_int(aff[0].n),
        fq.to_mont_int(aff[1].n),
        _ONE_LIMBS,
    )


def _g2_limbs(pt):
    """Oracle G2 point -> stacked (4, L) affine Fq2 limbs; None for infinity
    (caller must fall back to the oracle for that item)."""
    aff = O.ec_to_affine(pt)
    if aff is None:
        return None
    x, y = aff
    return np.stack(
        [
            fq.to_mont_int(x.c0),
            fq.to_mont_int(x.c1),
            fq.to_mont_int(y.c0),
            fq.to_mont_int(y.c1),
        ]
    )


def batch_verify_point_proofs(setup, commitments: Sequence, proofs: Sequence,
                              zs: Sequence[int], ys: Sequence[int],
                              device=None, mesh=None) -> np.ndarray:
    """N independent `verify_point_proof` checks in one device pipeline.
    ``commitments``/``proofs`` are oracle G1 points; ``zs``/``ys`` scalar
    field ints. ``device=None`` runs on the CUDA card (and raises without
    one), ``device="cpu"`` the plain steps. With ``mesh``, the batch's
    rows shard over its slots."""
    dev = torch_env.resolve(device, mesh)
    n = len(commitments)
    assert len(proofs) == n and len(zs) == n and len(ys) == n
    if n == 0:
        return np.zeros(0, dtype=bool)

    lay = _FoldLayout("aggregate_verify", 2, n, mesh)
    prA, rows, nb = lay.program, lay.rows, lay.nb
    L = fq.NUM_LIMBS

    active = np.zeros(nb, dtype=bool)
    oracle_fallback = {}  # index -> bool (degenerate [tau-z]G2)
    pk_x = np.zeros((nb, 2, L), dtype=np.uint64)
    pk_y = np.zeros((nb, 2, L), dtype=np.uint64)
    pk_y[:] = _INF_G1[1]
    pk_z = np.zeros((nb, 2, L), dtype=np.uint64)
    hm = np.zeros((nb, 2, 4, L), dtype=np.uint64)
    hm[:] = _G2GEN_LIMBS
    sg = np.zeros((nb, 4, L), dtype=np.uint64)
    sg[:] = _G2GEN_LIMBS

    r = O.R
    for i in range(n):
        z, y = int(zs[i]) % r, int(ys[i]) % r
        # host scalar work: [tau - z]G2 and [y]G1 - C + G1
        h0_pt = O.ec_add(setup.g2[1], O.ec_neg(O.ec_mul(O.G2_GEN, z)))
        h0 = _g2_limbs(h0_pt)
        if h0 is None:
            # z == tau (trusted-setup secret leaked into the query — test
            # setups only): no affine form; answer via the oracle
            from ..utils import kzg as _kzg

            oracle_fallback[i] = _kzg.verify_point_proof(
                setup, commitments[i], proofs[i], z, y
            )
            continue
        c_term = O.ec_add(
            O.ec_add(O.ec_mul(O.G1_GEN, y), O.ec_neg(commitments[i])), O.G1_GEN
        )
        pk_x[i, 0], pk_y[i, 0], pk_z[i, 0] = _g1_limbs(proofs[i])
        pk_x[i, 1], pk_y[i, 1], pk_z[i, 1] = _g1_limbs(c_term)
        hm[i, 0] = h0
        active[i] = True

    out_ok = np.zeros(nb, dtype=bool)
    if active.any():
        ins = {}
        lay.scatter(ins, pk_x, lambda j: f"pk{j}.x")
        lay.scatter(ins, pk_y, lambda j: f"pk{j}.y")
        lay.scatter(ins, pk_z, lambda j: f"pk{j}.z")
        lay.scatter(ins, hm, lambda j, ci: f"h{j}.{_G2_COMPS[ci]}")
        lay.scatter(ins, sg, lambda ci: f"sig.{_G2_COMPS[ci]}")
        out = vm.execute(prA, ins, batch_shape=(rows,), device=dev,
                         mesh=mesh)
        g_batch = np.zeros((nb, 12, L), dtype=np.uint64)
        usable = active.copy()
        for i in range(nb):
            if not usable[i]:
                continue
            rr, ns = lay.split(i)
            f_coeffs = [
                fq.from_mont_limbs(out[f"{ns}f.{j}"][rr]) for j in range(12)
            ]
            g = _easy_part_flat(f_coeffs)
            if g is None:
                usable[i] = False
                continue
            for j in range(12):
                g_batch[i, j] = fq.to_mont_int(g[j])
        ok = _run_hard_part(g_batch, dev, mesh=mesh)
        out_ok = ok & usable

    for i, verdict in oracle_fallback.items():
        out_ok[i] = verdict
    return out_ok[:n]
