"""The mainnet-scale workload replay of the port (the counterpart of
consensus_specs_tpu/bench/mainnet.py), ``run_mainnet_bench(device=None)``:
every verification on ``device`` (None: the CUDA card), the fleet's
workers too.

Replays full mainnet-shape slots end-to-end over a synthetic
million-validator registry: mainnet-preset committee shuffling (64
committees/slot, ~n/2048 validators each), real index-derived pubkeys,
per-committee aggregate signatures, hierarchical aggregate-of-
aggregates verification (per-committee aggregates via the RLC combine,
committee verdicts folded to ONE final exp per slot), the pubkey plane
holding the decompressed working set under a byte budget.

Sections (the ``mainnet`` dict; each carries an ``ok`` gate, the
throughput numbers are report-only):

- ``mainnet[slot_replay]``   — warm-round attestations/sec +
  final_exps_per_slot + pubkey-plane hit rate + peak RSS vs budget.
- ``mainnet[bad_committee]`` — a forced bad committee at full fan-out,
  localized exactly by bisection.
- ``mainnet[censored_sim]``  — simnet's ``censored_aggregates`` at
  mainnet committee fan-out (64 committees/slot via a scaled minimal
  world) through the STRICT convergence gate, censorship evidence
  asserted.
- ``mainnet[affinity]``      — the slot's committees routed twice
  through a real 2-worker fleet on committee-index affinity: stable
  assignment, zero moves.

The slot's pubkeys and signatures are derived in a ``utils.keygen``
spawn pool past 65,536 validators (one process below).
"""
import os
import time

VALIDATORS_ENV = "CONSENSUS_SPECS_TPU_SCALE_VALIDATORS"
SLOTS_ENV = "CONSENSUS_SPECS_TPU_SCALE_SLOTS"
RSS_BUDGET_ENV = "CONSENSUS_SPECS_TPU_SCALE_RSS_MB"
SIM_VALIDATORS_ENV = "CONSENSUS_SPECS_TPU_SCALE_SIM_VALIDATORS"
FLEET_WORKERS_ENV = "CONSENSUS_SPECS_TPU_SCALE_FLEET_WORKERS"

_DEFAULT_VALIDATORS = 1 << 20
_DEFAULT_RSS_MB = 8192
# 2048 minimal-preset validators -> 2048/8/4 = 64 committees per slot:
# the TRUE mainnet fan-out (MAX_COMMITTEES_PER_SLOT) at sim scale
_DEFAULT_SIM_VALIDATORS = 2048


def run_mainnet_bench(device=None) -> dict:
    from ..device import resolve_device
    from ..obs import latency
    from ..ops import bls_backend, profiling
    from ..scale import hierarchy, routing
    from ..scale.pubkeys import PubkeyPlane, peak_rss_bytes
    from ..scale.registry import Registry
    from ..utils.keygen import KeyPool

    dev = resolve_device(device)
    profiling.reset()
    latency.reset()
    bls_backend.reset_call_counts()

    n = int(os.environ.get(VALIDATORS_ENV, str(_DEFAULT_VALIDATORS)))
    n_slots = max(1, int(os.environ.get(SLOTS_ENV, "1")))
    rss_budget_mb = float(os.environ.get(RSS_BUDGET_ENV,
                                         str(_DEFAULT_RSS_MB)))
    sim_validators = int(os.environ.get(SIM_VALIDATORS_ENV,
                                        str(_DEFAULT_SIM_VALIDATORS)))
    fleet_workers = int(os.environ.get(FLEET_WORKERS_ENV, "2"))

    sections = {}
    all_ok = True

    # -- registry + slot traffic ------------------------------------------
    t0 = time.perf_counter()
    reg = Registry(n, seed=20)
    per_slot = reg.committees_per_slot()
    committees = [reg.committees_at_slot(s) for s in range(n_slots)]
    shuffle_s = time.perf_counter() - t0
    committee_size = len(committees[0][0])

    t0 = time.perf_counter()
    with KeyPool(None if n >= 1 << 16 else 1) as pool:
        slot_items = [hierarchy.committee_items(reg, slot=s, pool=pool)
                      for s in range(n_slots)]
    derive_s = time.perf_counter() - t0

    plane = PubkeyPlane(device=dev)

    # -- mainnet[slot_replay]: cold round warms, warm round is timed ------
    cold_s = 0.0
    cold_reports = []
    for s, items in enumerate(slot_items):
        rep = hierarchy.verify_slot(items, slot=s, plane=plane, device=dev)
        cold_reports.append(rep)
        cold_s += rep.verify_s
    plane_hits0, plane_misses0 = plane.hits, plane.misses

    warm_reports = []
    warm_s = 0.0
    for s, items in enumerate(slot_items):
        rep = hierarchy.verify_slot(items, slot=s, plane=plane, device=dev)
        warm_reports.append(rep)
        warm_s += rep.verify_s
    atts = sum(r.attestations for r in warm_reports)
    atts_per_sec = atts / warm_s if warm_s > 0 else 0.0
    warm_hits = plane.hits - plane_hits0
    warm_misses = plane.misses - plane_misses0
    warm_hit_rate = (warm_hits / (warm_hits + warm_misses)
                     if (warm_hits + warm_misses) else 0.0)
    final_exps_per_slot = (sum(r.final_exps for r in warm_reports)
                           / len(warm_reports))
    peak_rss_mb = peak_rss_bytes() / (1 << 20)

    replay_ok = (all(r.all_valid for r in cold_reports + warm_reports)
                 and final_exps_per_slot == 1.0
                 and warm_hit_rate == 1.0
                 and plane.bytes <= plane.budget_bytes
                 and peak_rss_mb <= rss_budget_mb)
    all_ok &= replay_ok
    sections["slot_replay"] = {
        "ok": bool(replay_ok),
        "validators": n,
        "slots": n_slots,
        "committees_per_slot": per_slot,
        "committee_size": committee_size,
        "attestations_per_slot": atts // n_slots,
        "atts_per_sec": round(atts_per_sec, 1),
        "verify_s_per_slot": round(warm_s / n_slots, 3),
        "cold_verify_s_per_slot": round(cold_s / n_slots, 3),
        "final_exps_per_slot": round(final_exps_per_slot, 3),
        "pubkey_hit_rate": round(warm_hit_rate, 4),
        "pubkey_plane_mb": round(plane.bytes / (1 << 20), 1),
        "pubkey_budget_mb": round(plane.budget_bytes / (1 << 20), 1),
        "peak_rss_mb": round(peak_rss_mb, 1),
        "rss_budget_mb": rss_budget_mb,
        "registry_shuffle_s": round(shuffle_s, 3),
        "pubkey_derive_s": round(derive_s, 3),
    }

    # -- mainnet[bad_committee]: bisection localization at full fan-out ---
    bad_ci = per_slot // 2
    items_b = list(slot_items[0])
    items_b[bad_ci] = hierarchy.corrupt_item(items_b[bad_ci])
    rep_b = hierarchy.verify_slot(items_b, slot=0, plane=plane, device=dev)
    bad_ok = (rep_b.bad_committees == [bad_ci] and rep_b.bisections >= 1)
    all_ok &= bad_ok
    sections["bad_committee"] = {
        "ok": bool(bad_ok),
        "planted": bad_ci,
        "localized": rep_b.bad_committees,
        "bisections": rep_b.bisections,
        "extra_final_exps": rep_b.final_exps - 1,
        "verify_s": round(rep_b.verify_s, 3),
    }

    # -- mainnet[censored_sim]: censorship resilience, strictly gated -----
    from ..sim.runner import SimDivergence, build_world, run_scenario
    from ..sim.scenarios import get_scenario

    spec, anchor_state, anchor_block = build_world(
        validators=sim_validators)
    sim_fanout = int(spec.get_committee_count_per_slot(
        anchor_state, spec.get_current_epoch(anchor_state)))
    try:
        sim_report = run_scenario(
            get_scenario("censored_aggregates"), spec=spec,
            anchor_state=anchor_state, anchor_block=anchor_block,
            strict=True, device=dev)
        sim_error = None
    except SimDivergence as e:
        sim_report = None
        sim_error = str(e)
    sim_ok = (sim_report is not None and sim_report.converged
              and sim_report.censored > 0)
    all_ok &= sim_ok
    sections["censored_sim"] = {
        "ok": bool(sim_ok),
        "sim_validators": sim_validators,
        "committees_per_slot": sim_fanout,
        "censored_validators": (sim_report.censored if sim_report else 0),
        "converged": bool(sim_report.converged) if sim_report else False,
        "error": sim_error,
        "digest": sim_report.digest if sim_report else "",
    }

    # -- mainnet[affinity]: committee-affinity fleet routing --------------
    if fleet_workers > 0:
        with routing.CommitteeFleet(workers=fleet_workers,
                                    backend="verdict", device=dev) as fleet:
            assign = fleet.assignment(range(per_slot))
            verdict_items = [
                ("fast_aggregate", [b"\x22" * 48],
                 b"mn%06d" % ci + b"\x00" * 24, b"\x11" * 96)
                for ci in range(per_slot)]
            rounds_ok = True
            for _ in range(2):
                rounds_ok &= all(fleet.submit_slot(verdict_items))
            aff_ok = (rounds_ok
                      and fleet.assignment(range(per_slot)) == assign
                      and fleet.affinity_moves == 0)
            spread = len(set(assign.values()))
        all_ok &= aff_ok
        sections["affinity"] = {
            "ok": bool(aff_ok),
            "workers": fleet_workers,
            "committees": per_slot,
            "workers_covered": spread,
            "moves": 0 if aff_ok else -1,
        }

    return dict(
        metric="mainnet attestations/sec (hierarchical slot fold, warm)",
        value=sections["slot_replay"]["atts_per_sec"],
        vs_baseline=sections["slot_replay"]["final_exps_per_slot"],
        unit="attestations/sec",
        mode="mainnet",
        platform=dev.type,
        validators=n,
        ok=bool(all_ok),
        atts_per_sec=sections["slot_replay"]["atts_per_sec"],
        final_exps_per_slot=sections["slot_replay"]["final_exps_per_slot"],
        pubkey_hit_rate=sections["slot_replay"]["pubkey_hit_rate"],
        peak_rss_mb=sections["slot_replay"]["peak_rss_mb"],
        mainnet=sections,
        rlc_stats=dict(bls_backend.RLC_STATS),
        profile=profiling.summary(),
    )
