"""Hierarchical aggregate-of-aggregates verification for one slot (the
port's counterpart of consensus_specs_tpu/scale/hierarchy.py; ``device=``
takes the place of ``mesh=``: None is the CUDA card, ``"cpu"`` the plain
PyTorch versions).

The Wonderboom shape (PAPERS.md): level 1 aggregates per-validator
signatures inside each committee (the registry emits those aggregates;
on the verify side ``_miller_fast_aggregate`` folds the committee's
pubkeys into ONE aggregate pubkey on device), level 2 folds the
committee verdicts up a slot-level tree. The fold is the RLC combine:
all committee Miller outputs of the slot are combined with fresh
random scalars into ONE product, so the whole slot pays ONE final
exponentiation (and via ``_FinalExpBatcher``, concurrent slots share
one pipelined execution). A failed slot root bisects the tree —
log2(committees) re-combines localize the bad committee EXACTLY, with
exact per-committee finalization at the leaves.

``verify_slot`` wraps ``ops.bls_backend.batch_verify_rlc`` (the RLC
fold + bisection engine every other plane uses — bit-identical
verdicts to the flat per-committee path) with the slot-level
accounting the mainnet workload reports: final-exps-per-slot,
bisection path, localized bad committees, pubkey-plane warmth.
"""
import time
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ..utils.keygen import KeyPool

CommitteeItem = Tuple[str, Sequence[bytes], object, bytes]


@dataclass
class SlotReport:
    """Per-slot verification accounting (one hierarchical fold)."""

    slot: int
    committees: int
    attestations: int  # individual attester signatures covered
    verdicts: np.ndarray
    bad_committees: List[int]
    combines: int
    bisections: int
    final_exps: int
    final_exp_windows: int
    verify_s: float
    pubkey_hits: int = 0
    pubkey_misses: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def all_valid(self) -> bool:
        return bool(self.verdicts.all()) if len(self.verdicts) else True

    @property
    def final_exps_per_slot(self) -> float:
        return float(self.final_exps)


def committee_items(registry, slot: int, participation: float = 1.0,
                    pool=None) -> List[CommitteeItem]:
    """The slot's full committee fan-out as backend-shaped items: every
    pubkey and signature of the slot derived in ``pool`` (a
    ``utils.keygen.KeyPool``; by default one process, the switchboard's
    own ``SkToPk`` and ``Sign``), in one pass each."""
    pool = pool or KeyPool(1)
    parts = [registry.aggregate_parts(slot, ci, participation)
             for ci in range(registry.committees_per_slot())]
    pks = registry.pubkeys(np.concatenate([m for m, _, _ in parts]), pool)
    sigs = pool.sign([(sk, msg) for _, sk, msg in parts])
    items, lo = [], 0
    for (members, _sk, msg), sig in zip(parts, sigs):
        items.append(("fast_aggregate", pks[lo:lo + len(members)], msg, sig))
        lo += len(members)
    return items


def verify_slot(items: Sequence[CommitteeItem], *, slot: int = 0,
                plane=None, device=None, rng=None, mesh=None) -> SlotReport:
    """Hierarchically verify one slot's committee aggregates.

    ``plane`` (a ``PubkeyPlane``) is warmed with the slot's full pubkey
    column first — batched decompression, byte-budgeted residency — so
    the backend's host prep runs entirely from warm columnar state.
    Verdict semantics are ``batch_verify_rlc``'s: bit-identical to the
    flat per-committee path on every input. ``mesh`` shards the slot's
    rows over its slots."""
    from ..ops import bls_backend, profiling

    items = list(items)
    hits = misses = 0
    if plane is not None:
        flat: List[bytes] = []
        for _, pks, _, _ in items:
            flat.extend(bytes(pk) for pk in pks)
        hits, misses = plane.warm(flat)

    before = dict(bls_backend.RLC_STATS)
    t0 = time.perf_counter()
    verdicts = bls_backend.batch_verify_rlc(items, device=device, rng=rng,
                                            mesh=mesh)
    verify_s = time.perf_counter() - t0
    after = bls_backend.RLC_STATS

    report = SlotReport(
        slot=slot,
        committees=len(items),
        attestations=sum(len(it[1]) for it in items),
        verdicts=np.asarray(verdicts, dtype=bool),
        bad_committees=[i for i, ok in enumerate(verdicts) if not ok],
        combines=after["combines"] - before["combines"],
        bisections=after["bisections"] - before["bisections"],
        final_exps=after["final_exps"] - before["final_exps"],
        final_exp_windows=(after["final_exp_windows"]
                           - before["final_exp_windows"]),
        verify_s=verify_s,
        pubkey_hits=hits,
        pubkey_misses=misses,
    )
    profiling.set_gauge("scale.final_exps_per_slot",
                        report.final_exps_per_slot)
    return report


def verify_slot_flat(items: Sequence[CommitteeItem],
                     device=None, mesh=None) -> np.ndarray:
    """Flat reference path: every committee finalized individually
    (no RLC fold — N final exps instead of 1). The smoke pins
    hierarchical == flat bit-identity on every traffic mix."""
    from ..ops import bls_backend

    out = np.zeros(len(items), dtype=bool)
    fast = [(i, it) for i, it in enumerate(items)
            if it[0] == "fast_aggregate"]
    agg = [(i, it) for i, it in enumerate(items) if it[0] == "aggregate"]
    if fast:
        v = bls_backend.batch_fast_aggregate_verify(
            [list(it[1]) for _, it in fast],
            [it[2] for _, it in fast],
            [it[3] for _, it in fast], device=device, mesh=mesh)
        for (i, _), ok in zip(fast, v):
            out[i] = bool(ok)
    if agg:
        v = bls_backend.batch_aggregate_verify(
            [list(it[1]) for _, it in agg],
            [list(it[2]) for _, it in agg],
            [it[3] for _, it in agg], device=device, mesh=mesh)
        for (i, _), ok in zip(agg, v):
            out[i] = bool(ok)
    return out


def verify_slot_oracle(items: Sequence[CommitteeItem]) -> np.ndarray:
    """Pure-python host-oracle path (the switchboard's ``oracle_*``
    functions, whatever its backend switch says): the ground truth the
    smoke's three-way identity gate anchors on."""
    from ..utils import bls

    out = np.zeros(len(items), dtype=bool)
    for i, (kind, pks, msgs, sig) in enumerate(items):
        if kind == "fast_aggregate":
            out[i] = bool(bls.oracle_fast_aggregate_verify(
                [bytes(pk) for pk in pks], bytes(msgs), bytes(sig)))
        else:
            out[i] = bool(bls.oracle_aggregate_verify(
                [bytes(pk) for pk in pks],
                [bytes(m) for m in msgs], bytes(sig)))
    return out


def corrupt_item(item: CommitteeItem) -> CommitteeItem:
    """A structurally valid but WRONG signature for the item: sign a
    different message with an unrelated key, so the corruption is only
    detectable by real pairing math (not by decode prechecks)."""
    from ..utils import bls

    kind, pks, msgs, _sig = item
    wrong = bls.Sign(0xBADC0FFEE, b"scale-corrupt" + b"\x00" * 19)
    return (kind, pks, msgs, wrong)
