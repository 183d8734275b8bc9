"""Mainnet workload canary of the port, on the card:

    python -m consensus_specs_tpu_torch.scale.smoke

A small-but-mainnet-preset slot: the committee count comes from the REAL
mainnet formula (get_committee_count_per_slot over the registry), only
the validator count is reduced
(``CONSENSUS_SPECS_TPU_SCALE_SMOKE_VALIDATORS``, default 8,192: 2
committees of 128). Three traffic rounds over the same
slot, each verified three ways — hierarchical (RLC slot fold), flat
(per-committee finalization) and the pure-Python host oracle — with all
three verdict vectors required bit-identical:

1. **valid**: every committee fully covered. The hierarchical fold must
   pay exactly ONE combine and ONE final exp for the whole slot.
2. **censored**: one committee's aggregate covers only a subset (the
   tail censored out). The uncensored cover must still verify AND the
   coverage loss must be detected (covered < fan-out).
3. **forced bad committee**: one committee carries a structurally valid
   but wrong signature. The slot root fails, bisection must localize
   EXACTLY that committee, and the flat/oracle paths must agree.

Phase 4 (``run_affinity``) routes the slot through a real 2-worker fleet
with committee-index affinity (verdict backend: affinity is
crypto-independent) and demands a stable committee->worker assignment
across rounds with zero affinity moves. Exit 0 on pass, 1 with a
diagnosis.
"""
import os
import sys

VALIDATORS_ENV = "CONSENSUS_SPECS_TPU_SCALE_SMOKE_VALIDATORS"
DEFAULT_VALIDATORS = 8192  # mainnet formula -> 2 committees of 128


def run_rounds(n_validators: int = DEFAULT_VALIDATORS, device=None,
               pool=None) -> dict:
    """The three rounds on ``device`` (None is the card). Returns each
    round's verdicts and accounting; raises AssertionError on any
    divergence or wrong accounting."""
    from ..obs import flight
    from . import hierarchy, pubkeys
    from .registry import Registry

    reg = Registry(n_validators, seed=20)
    per_slot = reg.committees_per_slot()
    fanout = sum(len(c) for c in reg.committees_at_slot(0))
    assert per_slot >= 2, (
        f"smoke needs >= 2 committees for localization; "
        f"{n_validators} validators give {per_slot}")
    flight.note("scale", "smoke_registry", validators=n_validators,
                committees_per_slot=per_slot, fanout=fanout)
    plane = pubkeys.PubkeyPlane(device=device)
    out = {"validators": n_validators, "committees_per_slot": per_slot,
           "fanout": fanout}

    def identity(tag, items, report):
        flat = hierarchy.verify_slot_flat(items, device=device)
        oracle = hierarchy.verify_slot_oracle(items)
        hier = report.verdicts.tolist()
        flight.note("scale", "smoke_verdicts", round=tag, hier=hier,
                    flat=flat.tolist(), oracle=oracle.tolist(),
                    final_exps=report.final_exps,
                    combines=report.combines, bisections=report.bisections)
        assert hier == flat.tolist() == oracle.tolist(), (
            f"{tag}: verdict divergence hier={hier} "
            f"flat={flat.tolist()} oracle={oracle.tolist()}")
        out[tag] = {"verdicts": hier, "combines": report.combines,
                    "bisections": report.bisections,
                    "final_exps": report.final_exps,
                    "bad_committees": report.bad_committees,
                    "attestations": report.attestations,
                    "verify_s": report.verify_s}
        return hier

    # -- round 1: valid slot, ONE final exp for the whole fold --------------
    items = hierarchy.committee_items(reg, slot=0, pool=pool)
    report = hierarchy.verify_slot(items, slot=0, plane=plane, device=device)
    hier = identity("valid", items, report)
    assert all(hier), f"valid slot rejected: {hier}"
    assert report.combines == 1 and report.bisections == 0, (
        f"valid slot paid {report.combines} combines / "
        f"{report.bisections} bisections; wanted the single slot fold")
    assert report.final_exps_per_slot == 1.0, (
        f"final_exps_per_slot {report.final_exps_per_slot} != 1")
    assert report.attestations == fanout
    assert plane.bytes <= plane.budget_bytes, (
        f"pubkey plane over budget: {plane.bytes} > {plane.budget_bytes}")

    # -- round 2: censored aggregate — subset cover still verifies ----------
    censored_ci, participation = 0, 0.75
    items_c = list(items)
    pks, msg, sig = reg.aggregate(0, censored_ci, participation=participation)
    items_c[censored_ci] = ("fast_aggregate", pks, msg, sig)
    report_c = hierarchy.verify_slot(items_c, slot=0, plane=plane,
                                     device=device)
    hier_c = identity("censored", items_c, report_c)
    assert all(hier_c), f"uncensored cover rejected: {hier_c}"
    censored = fanout - report_c.attestations
    assert censored > 0, "censorship went undetected: full coverage"
    out["censored"]["censored_validators"] = censored

    # -- round 3: forced bad committee, localized by bisection --------------
    bad_ci = per_slot - 1
    items_b = list(items)
    items_b[bad_ci] = hierarchy.corrupt_item(items_b[bad_ci])
    report_b = hierarchy.verify_slot(items_b, slot=0, plane=plane,
                                     device=device)
    hier_b = identity("bad_committee", items_b, report_b)
    assert report_b.bad_committees == [bad_ci], (
        f"bisection localized {report_b.bad_committees}, planted {bad_ci}")
    assert report_b.bisections >= 1, "slot root failed without bisecting"
    assert [i for i, ok in enumerate(hier_b) if ok] == [
        i for i in range(per_slot) if i != bad_ci]
    out["bad_committee"]["planted"] = bad_ci
    out["pubkey_plane_bytes"] = plane.bytes
    out["pubkey_budget_bytes"] = plane.budget_bytes
    return out


def run_affinity(per_slot: int, device=None, workers: int = 2) -> dict:
    """Phase 4: ``per_slot`` committees routed twice through a
    ``workers``-worker verdict fleet on ``device`` (None is the card) by
    committee-index affinity. Returns the assignment; raises
    AssertionError on a wrong verdict, a drifting assignment or an
    affinity move."""
    from ..obs import flight
    from . import routing

    with routing.CommitteeFleet(workers=workers, backend="verdict",
                                device=device) as fleet:
        assign = fleet.assignment(range(per_slot))
        verdict_items = [("fast_aggregate", [b"\x22" * 48],
                          b"scale%03d" % ci + b"\x00" * 23, b"\x11" * 96)
                         for ci in range(per_slot)]
        for _round in range(2):
            got = fleet.submit_slot(verdict_items)
            assert all(got), f"fleet round verdicts: {got}"
        assert fleet.assignment(range(per_slot)) == assign, (
            "committee->worker assignment drifted between rounds")
        assert fleet.affinity_moves == 0, (
            f"{fleet.affinity_moves} affinity moves on a stable ring")
        routed = fleet.committees_routed
    flight.note("scale", "smoke_affinity",
                assignment={str(k): v for k, v in assign.items()})
    return {"assignment": assign, "committees_routed": routed,
            "workers_covered": len(set(assign.values()))}


def main() -> int:
    n = int(os.environ.get(VALIDATORS_ENV, str(DEFAULT_VALIDATORS)))
    try:
        res = run_rounds(n)
        aff = run_affinity(res["committees_per_slot"])
    except Exception as e:  # noqa: BLE001 - the smoke's diagnosis
        print(f"mainnet-smoke FAIL: {type(e).__name__}: {e}")
        return 1
    print(f"mainnet-smoke: valid slot OK — {res['committees_per_slot']} "
          f"committees, {res['valid']['attestations']} attestations, "
          f"final_exps_per_slot={res['valid']['final_exps']}, "
          f"verify {res['valid']['verify_s']:.2f}s")
    print(f"mainnet-smoke: censored round OK — "
          f"{res['censored']['censored_validators']} validators censored "
          f"out of committee 0, subset cover verified")
    print(f"mainnet-smoke: bad committee {res['bad_committee']['planted']} "
          f"localized by {res['bad_committee']['bisections']} bisection(s)")
    print(f"mainnet-smoke: committee affinity stable across rounds "
          f"({aff['workers_covered']} workers covered)")
    print("mainnet-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
