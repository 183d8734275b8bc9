"""Per-stage latency plane of the serve pipeline and the chain plane (the
port's copy of consensus_specs_tpu/obs/latency.py).

- **births**: a gossip item may carry a ``Birth`` (monotone trace id +
  perf-counter timestamp) into ``VerificationService.submit(birth_s=...)``;
  the id doubles as the Chrome-trace flow id (``obs/tracing.py``).
- **per-stage histograms**: each pipeline stage records its duration into
  the ``latency[<stage>]`` dynamic family, the same mergeable log-bucket
  histograms (``obs/hist.py``) every other latency number uses.
- **the end-to-end number**: ``latency.gossip_to_head``, birth to the
  ``HeadService`` head update that reflects the item's vote
  (``chain/head_service.py``).
- **the control input**: ``downstream_p99_s()`` reads the live p99 of the
  stages a queued item still has ahead of it (prep, device, finalize):
  what the serve plane's deadline-aware flush subtracts from the remaining
  slot budget to decide whether waiting for a fuller batch would blow the
  deadline.

Recording costs one histogram observe per stage per flush (plus one per
item for queue_wait): flush scale, so the plane stays on without an env
gate.
"""
import itertools
import threading
import time
from typing import Dict, Optional, Tuple

from ..ops import profiling

# the end-to-end family (registered in obs/registry.py LATENCIES)
GOSSIP_TO_HEAD_LABEL = "latency.gossip_to_head"

# per-stage dynamic family latency[<stage>]: the serve pipeline's stages,
# the chain batch stages, the ingress hop (birth -> submit accepted) and
# every ssz_impl.hash_tree_root, fixed so the label cardinality is bounded
# by construction
STAGES: Tuple[str, ...] = (
    "ingress", "queue_wait", "prep", "device", "combine", "finalize",
    "validate", "sig_wait", "apply", "sweep", "head",
    "merkle_root",
)

# what a QUEUED serve item still has ahead of it: the stages whose
# observed p99 the deadline-aware flush budgets for
DOWNSTREAM_STAGES: Tuple[str, ...] = ("prep", "device", "finalize")

_ids = itertools.count(1)


class Birth:
    """One gossip item's ingress record: a process-unique trace id (the
    Chrome flow id) and the perf-counter timestamp of arrival."""

    __slots__ = ("trace_id", "t")

    def __init__(self, trace_id: int, t: float):
        self.trace_id = trace_id
        self.t = t

    def __repr__(self):
        return f"Birth(id={self.trace_id}, t={self.t:.6f})"


def birth(t: Optional[float] = None) -> Birth:
    """Stamp one gossip arrival."""
    return Birth(next(_ids), time.perf_counter() if t is None else t)


def stage_label(stage: str) -> str:
    return f"latency[{stage}]"


def note_stage(stage: str, seconds: float) -> None:
    """One stage-duration observation into the mergeable per-stage
    histogram family (``latency[<stage>]``)."""
    profiling.record_latency(stage_label(stage), seconds)


def note_gossip_to_head(seconds: float) -> None:
    """One end-to-end observation: gossip birth -> the head update that
    reflects the item's vote."""
    profiling.record_latency(GOSSIP_TO_HEAD_LABEL, seconds)


# downstream-p99 read cache: the flush scheduler consults it on every
# collect, and the number moves at flush cadence, so one histogram read
# per max_age window is plenty
_p99_lock = threading.Lock()
_p99_cache = {"t": 0.0, "v": 0.0}


def downstream_p99_s(stages: Tuple[str, ...] = DOWNSTREAM_STAGES,
                     max_age_s: float = 0.05) -> float:
    """Sum of the live p99s of ``stages`` (seconds): the observed cost of
    everything a queued item still has to pay after a flush fires, cached
    ``max_age_s`` (the cache is shared across callers). Stages with no
    observations contribute 0: a cold pipeline budgets optimistically and
    learns within one flush."""
    now = time.monotonic()
    with _p99_lock:
        if now - _p99_cache["t"] < max_age_s:
            return _p99_cache["v"]
    hists = profiling.latency_histograms()
    total = 0.0
    for stage in stages:
        h = hists.get(stage_label(stage))
        if h is not None and h.count:
            total += h.percentile(99.0)
    with _p99_lock:
        _p99_cache["t"] = now
        _p99_cache["v"] = total
    return total


def snapshot() -> Dict[str, Dict]:
    """The per-stage families' summary dicts, for bench JSON lines."""
    return {label: h.summary()
            for label, h in profiling.latency_histograms().items()
            if label.startswith("latency[")}


def reset() -> None:
    """Fresh trace-id counter and a cold p99 cache (the histograms live in
    ``ops/profiling`` and reset with ``profiling.reset()``)."""
    global _ids
    _ids = itertools.count(1)
    with _p99_lock:
        _p99_cache["t"] = 0.0
        _p99_cache["v"] = 0.0
