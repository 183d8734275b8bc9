"""Metric-name registry and Prometheus text rendering (the port's copy
of consensus_specs_tpu/obs/registry.py, holding the families the port
publishes).

One source of truth for every label the port feeds into ``ops/profiling``
(gauges via ``set_gauge``, stat accumulators via ``record`` / ``timed``,
latency histograms via ``record_latency``). ``render_prometheus()``
renders ``profiling``'s snapshot as Prometheus text format 0.0.4:
registered names become metric families of their own; dynamic labels
(the per-shape VM execution timings ``vm[steps=...,regs=...,batch=...]``,
the per-lane ``device[<lane>]`` gauges) map onto ONE family each with
the full label string as a ``label`` label, so shapes never mint
unbounded metric names.
"""
import re
from typing import Dict, Iterable

PROM_PREFIX = "consensus_specs_tpu_"

# -- the registry -----------------------------------------------------------

# The help text of every name both packages publish is the JAX package's,
# word for word: a fleet aggregator of either package renders a worker
# snapshot of either package to the same scrape.

# every span stage a plane may stamp onto a trace, by plane: the list
# ``obs/tracing.py`` re-exports
SPAN_STAGES: Dict[str, tuple] = {
    # the serve pipeline's five per-request stages (`combine` only on
    # RLC-routed flushes)
    "serve": ("queue_wait", "prep", "device", "combine", "finalize"),
    # the chain plane's per-gossip-batch stages (`head` is the sweep's
    # head refresh and the gossip->head latency recording)
    "chain": ("validate", "sig_wait", "apply", "sweep", "head"),
    # `ingress` spans a gossip item's birth to its acceptance into the
    # serve queue, on request traces whose submit carried a birth time
    "latency": ("ingress",),
}

GAUGES: Dict[str, str] = {
    "serve.queue_depth": "ingress queue depth after the last enqueue/flush",
    "serve.cache_hit_rate": "share of non-eager submits answered by the "
                            "result cache or in-flight dedup",
    "serve.occupancy_rows": "filled batch rows / padded rows (batch axis "
                            "rounds up to a power of two)",
    "serve.occupancy_lanes": "actual committee keys / (rows * K bucket)",
    "serve.mesh_devices": "devices in the verify plane's mesh (0 = "
                          "single-device path; CONSENSUS_SPECS_TPU_MESH)",
    "serve.mesh_fallbacks": "mesh-sharded verify attempts that degraded to "
                            "the single-device path (ladder rung 0)",
    "serve.ladder_rung": "commanded degradation-ladder rung for the "
                         "service (0 = RLC combine, 1 = per-group batched, "
                         "2 = sequential oracle; the fleet router's shed "
                         "decisions move it)",
    "serve.deadline_flushes": "flushes fired early by the slot-budget "
                              "rule (remaining slot time minus the "
                              "observed downstream p99 would have been "
                              "blown by waiting for size-or-deadline; "
                              "CONSENSUS_SPECS_TPU_SLOT_MS arms it)",
    "serve.deadline_budget_ms": "slot budget remaining at the most "
                                "recent deadline-driven flush (ms, after "
                                "subtracting the downstream p99)",
    "chain.blocks": "blocks tracked by the proto-array (post-pruning)",
    "chain.head_slot": "slot of the maintained fork-choice head",
    "chain.head_changes": "head pointer moves since service start",
    "chain.reorgs": "head moves that rolled back at least one slot",
    "chain.last_reorg_depth": "slots rolled back by the most recent reorg",
    "chain.applied_attestations": "verified attestations that moved a "
                                  "latest message",
    "chain.deferred_attestations": "attestations parked for a missing "
                                   "block / future slot (cumulative)",
    "chain.dropped_attestations": "attestations rejected: bad signature, "
                                  "non-viable vote, or retries exhausted",
    "chain.deferred_pending": "deferral buffer depth right now",
    "chain.speculative_applied": "attestations applied to the proto-array "
                                 "BEFORE their signature verdicts "
                                 "returned (CONSENSUS_SPECS_TPU_SPECULATE; "
                                 "rolled back on failure)",
    "chain.rollbacks": "speculative batches reverted because at least one "
                       "member's signature verdict came back False "
                       "(weight-delta reversal; the verified members "
                       "re-apply)",
    "merkle.native_levels": "tree levels hashed through one batched "
                            "native sha256_hash_many call (vs per-pair "
                            "hashlib)",
    "merkle.cache_hits": "hash_tree_root calls answered by the "
                         "incremental layer cache (dirty-set re-hash "
                         "instead of a cold rebuild)",
    "merkle.dirty_nodes": "tree nodes re-hashed by incremental "
                          "dirty-set propagation (O(log N · changed) "
                          "per update)",
    "merkle.fallbacks": "Merkleization batch attempts that fell back "
                        "to the pure-python path (native lib missing "
                        "or dynamically-shaped elements)",
    "health.participation_rate": "attesting balance / total balance in "
                                 "the proto-array's tables, computed "
                                 "once per slot (chain/health.py)",
    "health.head_churn": "head pointer moves observed this slot",
    "health.reorg_depth": "deepest rollback among this slot's reorgs "
                          "(0 when the head only extended)",
    "health.finality_lag_slots": "current slot minus the finalized "
                                 "checkpoint epoch's start slot (a "
                                 "healthy chain holds ~2 epochs)",
    "health.deferral_depth": "deferral-buffer depth at the slot "
                             "boundary (gossip ahead of its "
                             "dependencies)",
    "health.rollback_rate": "speculative batches reverted this slot",
    "health.unexplained_reorgs": "cumulative reorgs observed outside "
                                 "declared disruption windows (the "
                                 "soak gate requires 0)",
    "fleet.workers": "live worker processes behind the fleet router "
                     "(drained workers leave the ring and this count)",
    "fleet.snapshots": "per-worker observability snapshots the fleet "
                       "aggregator has merged",
    "fleet.requests": "requests the fleet router has routed to workers "
                      "(consistent-hash result-cache affinity)",
    "fleet.sheds": "SLO-burn-driven shed decisions (a worker commanded "
                   "one rung down the RLC->per-group->oracle ladder)",
    "fleet.drains": "SLO-burn-driven drain decisions (a worker removed "
                    "from the ring and drained)",
    "bls.prep_serial_fallback_items": "items that degraded to serial "
                                      "per-item host prep",
    "bls.rlc_combines": "RLC combine programs run (process-wide)",
    "bls.rlc_bisections": "failed combined checks that forced a bisection "
                          "split",
    "bls.final_exps": "final exponentiations paid (device rows incl. "
                      "padding + host-oracle hard parts)",
    "bls.final_exp_rows_inflight": "hard-part rows the last device "
                                   "finalization window coalesced (>= 2 "
                                   "means concurrent flushes pipelined "
                                   "one VM execution)",
    "bls.vm_cache_hits": "assembled VM programs served from the .vm_cache/ "
                         "disk cache this process",
    "bls.vm_cache_misses": "VM programs that had to pay host assembly "
                           "(list scheduling) this process",
    "hist.families": "latency-histogram families tracked by this process "
                     "(mergeable log-bucketed distributions)",
    "device.count": "devices (plus the host prep lane) the occupancy "
                    "ledger has seen busy",
    "device.busy_s": "total busy seconds across all device lanes since "
                     "ledger start/reset",
    "flight.events": "structured events the flight recorder has journaled "
                     "(ring-bounded; see flight.dropped)",
    "flight.dropped": "flight-recorder events overwritten by ring churn "
                      "(raise CONSENSUS_SPECS_TPU_FLIGHT_RING)",
    "flight.dumps": "flight-recorder JSONL dumps written (on fault or on "
                    "demand)",
    "slo.ok": "1 when every declared objective is currently met "
              "(vacuously 1 with no observations)",
    "slo.violations": "declared objectives currently out of budget",
    "slo.worst_burn_rate": "highest burn rate across objectives and "
                           "windows (1.0 = consuming error budget exactly "
                           "at the sustainable rate)",
    "lightclient.proofs_served": "proof requests answered by the "
                                 "ProofService (hit, in-flight join, or "
                                 "fresh build)",
    "lightclient.proof_builds": "per-slot proof artifacts actually "
                                "materialized (cache misses that owned "
                                "the build)",
    "lightclient.cache_hit_rate": "share of served proofs answered "
                                  "without a rebuild (cache hits + "
                                  "in-flight joins) / served",
    "lightclient.inflight_joins": "proof requests that joined a "
                                  "concurrent in-flight build instead of "
                                  "duplicating it",
    "lightclient.updates_verified": "sync-committee signatures on served "
                                    "updates verified True through the "
                                    "VerificationService fast path",
    "lightclient.verify_failures": "sync-committee signature verdicts "
                                   "that came back False (the artifact "
                                   "is still served, flagged unverified)",
    "timeseries.samples": "fixed-interval samples the time-series "
                          "store has recorded since process start",
    "timeseries.points": "points currently retained across every "
                         "ring level (bounded by "
                         "CONSENSUS_SPECS_TPU_TS_CAP per level)",
    "timeseries.evicted": "points dropped by ring eviction (the "
                          "coarser levels still cover the horizon)",
    "process.rss_bytes": "resident set size of this process "
                         "(/proc/self/statm; the soak's memory-leak "
                         "detector, per worker on the fleet surface)",
    "process.cpu_s": "user+system CPU seconds consumed by this "
                     "process (resource.getrusage)",
    "process.open_fds": "open file descriptors held by this process "
                        "(/proc/self/fd count; -1 when unreadable)",
    "scale.pubkey_cache_hits": "pubkey-plane lookups served from the "
                               "bytes-budgeted LRU of decompressed G1 "
                               "keys",
    "scale.pubkey_cache_misses": "pubkey-plane lookups that paid "
                                 "batched G1 decompression through the "
                                 "vectorized codec path",
    "scale.pubkey_cache_bytes": "decompressed-key bytes currently "
                                "resident in the pubkey plane (held "
                                "under CONSENSUS_SPECS_TPU_SCALE_"
                                "PK_BUDGET_MB)",
    "scale.pubkey_cache_evictions": "LRU entries evicted (and "
                                    "un-mirrored from the backend host "
                                    "cache) to stay under the byte "
                                    "budget",
    "scale.pubkey_hit_rate": "pubkey-plane hits / (hits + misses) over "
                             "the process lifetime",
    "scale.final_exps_per_slot": "final exponentiations the last "
                                 "hierarchical slot fold paid (1 = the "
                                 "whole slot shared one RLC root)",
    "scale.committees_routed": "distinct committees the affinity "
                               "router has assigned to fleet workers",
    "scale.affinity_moves": "committees whose affine worker changed "
                            "(ring churn from drains/respawns; 0 on a "
                            "stable fleet)",
}

STATS: Dict[str, str] = {
    "serve.batch_flush": "per-(kind, K-bucket) group verification time "
                         "within a flush",
    "serve.prep_flush": "host codec prep time per micro-batch (pipeline "
                        "stage 1)",
    "serve.prep_error": "prep-stage exceptions (prep is an optimization; "
                        "the device stage re-derives)",
    "serve.rlc_error": "whole-flush RLC attempts that exhausted retries "
                       "and fell back to the per-group path",
    "serve.backend_error": "per-group backend failures that degraded to "
                           "the sequential oracle",
}

LATENCIES: Dict[str, str] = {
    "serve.submit_to_result": "submit()->Future-resolution latency "
                              "(p50/p95/p99 over a mergeable log-bucket "
                              "histogram)",
    "chain.apply_batch": "per-gossip-batch apply latency: validate + "
                         "signature wait + latest-message apply + sweep",
    "latency.gossip_to_head": "END-TO-END gossip→head latency: an item's "
                              "ingress birth to the head update that "
                              "reflects its vote (the speculative update "
                              "when speculation is on) — the "
                              "gossip_to_head_p99 SLO's histogram, "
                              "fleet-mergeable like every latency family",
}

# dynamic label families: labels built at run time with a shape or lane
# payload; ``prefix`` -> (prometheus family, help). The whole label string
# is exposed as a `label` label on the family.
DYNAMIC_PREFIXES: Dict[str, tuple] = {
    "vm[": ("vm_execute", "per-program VM execution timing, labelled "
                          "vm[steps=...,regs=...,batch=...,sharded=...]"),
    "device[": ("device_busy_frac", "per-device occupancy (busy seconds / "
                                    "elapsed), labelled device[<index>] "
                                    "(device[host] is the prep lane)"),
    "latency[": ("latency_stage", "per-stage gossip→head latency "
                                  "histograms, labelled latency[<stage>] "
                                  "over the fixed obs/latency.py stage "
                                  "set (ingress/queue_wait/prep/device/"
                                  "combine/finalize/validate/sig_wait/"
                                  "apply/sweep/head plus the proof plane's "
                                  "proof_build/proof_verify/proof_serve "
                                  "and the Merkleization plane's "
                                  "merkle_root)"),
    # node-labelled instances: N HeadService or VerificationService
    # instances in one process, or N fleet workers on the merged surface,
    # export under chain[<node>].<name> / serve[<node>].<name> /
    # lightclient[<node>].<name> / health[<node>].<name> via node_label()
    "chain[": ("chain_node", "per-node chain-plane metrics from multi-"
                             "instance (simnet) runs, labelled "
                             "chain[<node>].<name> — same names as the "
                             "chain.* family"),
    "serve[": ("serve_node", "per-node serve-plane metrics from multi-"
                             "instance (simnet) runs, labelled "
                             "serve[<node>].<name> — same names as the "
                             "serve.* family"),
    "lightclient[": ("lightclient_node", "per-node light-client proof-"
                                         "plane metrics from multi-"
                                         "instance (simnet) runs, "
                                         "labelled lightclient[<node>]."
                                         "<name> — same names as the "
                                         "lightclient.* family"),
    "health[": ("health_node", "per-node consensus health ledger rows "
                               "from multi-instance (simnet) runs, "
                               "labelled health[<node>].<name> — same "
                               "names as the health.* family"),
    "process[": ("process_node", "per-worker process resource gauges "
                                 "on the merged fleet surface, "
                                 "labelled process[<worker>].<name> — "
                                 "same names as the process.* family "
                                 "(resources must never SUM across "
                                 "workers: each is one process's)"),
}


def node_label(base: str, node) -> str:
    """``serve.queue_depth`` -> ``serve[<node>].queue_depth`` when a node
    name is set: the one spelling of the instance-labelled form.
    ``node`` None returns ``base`` unchanged (the single-instance shape).
    """
    if node is None:
        return base
    plane, name = base.split(".", 1)
    label = f"{plane}[{node}].{name}"
    assert known(label), f"unregistered node-labelled family for {base!r}"
    return label


def all_names() -> Iterable[str]:
    """Every registered static metric name (drift-gate + docs surface)."""
    names = []
    names.extend(sorted(GAUGES))
    names.extend(sorted(STATS))
    names.extend(sorted(LATENCIES))
    return names


def known(label: str) -> bool:
    """True when ``label`` is registered (exactly or via a dynamic prefix)."""
    if label in GAUGES or label in STATS or label in LATENCIES:
        return True
    return any(label.startswith(p) for p in DYNAMIC_PREFIXES)


# -- Prometheus text rendering ----------------------------------------------


def _ident(label: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", label)


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _family(label: str):
    """(prometheus base name, label-value or None) for a profiling label."""
    if label in GAUGES or label in STATS or label in LATENCIES:
        return PROM_PREFIX + _ident(label), None
    for prefix, (fam, _help) in DYNAMIC_PREFIXES.items():
        if label.startswith(prefix):
            return PROM_PREFIX + fam, label
    return PROM_PREFIX + "unregistered", label


def _series(name: str, label_value, value) -> str:
    if label_value is None:
        return f"{name} {value}"
    return f'{name}{{label="{_escape(label_value)}"}} {value}'


def render_prometheus(stats=None, gauges=None, hists=None) -> str:
    """Prometheus text format 0.0.4 over the live profiling snapshot, or,
    when the (``stats``, ``gauges``, ``hists``) triple is passed, over
    that state instead: the fleet aggregator (``obs/fleet.py``) renders
    its merged cross-process view through this renderer.

    Stat accumulators render as ``_calls_total`` / ``_seconds_total``
    counters and a ``_max_seconds`` gauge; latency histograms render
    twice: a summary (quantiles 0.5 / 0.95 / 0.99 with ``_sum`` /
    ``_count``) and a full Prometheus histogram family (``_hist_bucket``
    with ``le`` labels, ``_hist_sum`` / ``_hist_count``) whose fixed
    log-bucket bounds merge exactly across processes; gauges render as
    they are. HELP/TYPE headers appear once per family even when dynamic
    labels fan it out into many series.
    """
    if stats is None and gauges is None and hists is None:
        from ..ops import profiling

        # one histogram snapshot per latency family: the summary lines and
        # the histogram lines below derive from the same detached copy, so
        # the two agree on count and sum within one scrape
        stats, gauges = profiling.stats_and_gauges()
        hists = profiling.latency_histograms()
    stats = stats or {}
    gauges = gauges or {}
    lat_hists = hists or {}
    entries = {label: ("stat", v) for label, v in stats.items()}
    entries.update({label: ("lat", h) for label, h in lat_hists.items()})
    entries.update({label: ("gauge", v) for label, v in gauges.items()})
    # family -> {"type": ..., "help": ..., "lines": [...]}
    families: Dict[str, Dict] = {}

    def fam(name, mtype, help_text):
        f = families.get(name)
        if f is None:
            f = families[name] = {"type": mtype, "help": help_text,
                                  "lines": []}
        return f["lines"]

    for label, (kind, value) in sorted(entries.items()):
        base, label_value = _family(label)
        if kind == "gauge":
            help_text = GAUGES.get(label, "unregistered gauge")
            fam(base, "gauge", help_text).append(
                _series(base, label_value, value))
        elif kind == "lat":
            h = value
            entry = h.summary()
            help_text = LATENCIES.get(label, "latency reservoir")
            name = base + "_latency_seconds"
            lines = fam(name, "summary", help_text)
            for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                           ("0.99", "p99_ms")):
                if label_value is None:
                    lines.append(f'{name}{{quantile="{q}"}} '
                                 f"{entry[key] / 1e3}")
                else:
                    lines.append(
                        f'{name}{{label="{_escape(label_value)}",'
                        f'quantile="{q}"}} {entry[key] / 1e3}')
            count = entry["count"]
            lines.append(_series(
                name + "_sum", label_value,
                round(entry["mean_ms"] / 1e3 * count, 6)))
            lines.append(_series(name + "_count", label_value, count))
            max_name = base + "_latency_max_seconds"
            fam(max_name, "gauge", help_text + " (max)").append(
                _series(max_name, label_value, entry["max_ms"] / 1e3))
            hist_name = base + "_latency_hist_seconds"
            hlines = fam(hist_name, "histogram",
                         help_text + " (mergeable log buckets)")
            extra = ("" if label_value is None
                     else f'label="{_escape(label_value)}",')
            for le, cum in h.buckets():
                hlines.append(
                    f'{hist_name}_bucket{{{extra}le="{le:.9g}"}} {cum}')
            hlines.append(
                f'{hist_name}_bucket{{{extra}le="+Inf"}} {h.count}')
            hlines.append(_series(hist_name + "_sum", label_value,
                                  round(h.sum, 9)))
            hlines.append(_series(hist_name + "_count", label_value,
                                  h.count))
        else:  # stat accumulator: calls/total_s/max_s
            entry = value
            help_text = STATS.get(label)
            if help_text is None and label_value is not None:
                for prefix, (f_name, f_help) in DYNAMIC_PREFIXES.items():
                    if label.startswith(prefix):
                        help_text = f_help
                        break
            help_text = help_text or "unregistered stat"
            fam(base + "_calls_total", "counter", help_text).append(
                _series(base + "_calls_total", label_value, entry["calls"]))
            fam(base + "_seconds_total", "counter",
                help_text + " (seconds)").append(
                _series(base + "_seconds_total", label_value,
                        entry["total_s"]))
            fam(base + "_max_seconds", "gauge", help_text + " (max)").append(
                _series(base + "_max_seconds", label_value, entry["max_s"]))

    out = []
    for name in sorted(families):
        f = families[name]
        out.append(f"# HELP {name} {f['help']}")
        out.append(f"# TYPE {name} {f['type']}")
        out.extend(f["lines"])
    return "\n".join(out) + "\n"
