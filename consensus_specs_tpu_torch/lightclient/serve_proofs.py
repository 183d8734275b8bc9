"""Proof serving: content-addressed cache front + in-flight dedup (the
port's copy of consensus_specs_tpu/lightclient/serve_proofs.py).

``ProofService`` sits between millions of read-only clients and the
(expensive) per-slot artifact build: the first request for a
``(slot, state_root)`` key builds and (optionally) routes the
sync-committee signature through a ``VerificationService``; every
concurrent duplicate joins the in-flight build's future, and every later
request is a cache hit. Semantics mirror ``serve/cache.py`` +
``serve/service.py``'s pending-table dedup — bounded LRU, hit/miss
counters, one lock, build outside the lock.

Observability: ``lightclient.*`` gauges (``ProofMetrics``, node-labelled
like the chain/serve planes), ``latency[proof_build|proof_verify|
proof_serve]`` stages through ``obs/latency``, and ``lightclient``-plane
flight-recorder events.
"""
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Callable, Dict, Optional

from ..obs import flight, latency
from ..obs.registry import node_label
from ..ops import profiling
from .proof_tree import ProofArtifact, proof_key

# bounded artifact cache size (entries); one artifact per head slot, so
# even the default covers hours of slots
CACHE_ENV = "CONSENSUS_SPECS_TPU_PROOF_CACHE"
# seconds a joiner/builder waits on the signature verdict
VERIFY_TIMEOUT_ENV = "CONSENSUS_SPECS_TPU_PROOF_VERIFY_TIMEOUT"


class ProofCache:
    """Bounded LRU keyed by ``proof_key`` (mirror of
    ``serve.cache.ResultCache``, holding artifacts instead of verdicts).
    Not internally locked — ``ProofService`` serializes access."""

    def __init__(self, capacity: int = 1024):
        assert capacity > 0
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, ProofArtifact]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes) -> Optional[ProofArtifact]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, key: bytes, artifact: ProofArtifact) -> None:
        self._entries[key] = artifact
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ProofMetrics:
    """Counters for one ProofService instance (``lightclient.*`` family,
    node-labelled so N simnet instances publish side by side)."""

    def __init__(self, node: Optional[str] = None):
        self._lock = threading.Lock()
        self._served_label = node_label("lightclient.proofs_served", node)
        self._builds_label = node_label("lightclient.proof_builds", node)
        self._hit_rate_label = node_label("lightclient.cache_hit_rate", node)
        self._joins_label = node_label("lightclient.inflight_joins", node)
        self._verified_label = node_label(
            "lightclient.updates_verified", node)
        self._verify_fail_label = node_label(
            "lightclient.verify_failures", node)
        self.served = 0
        self.builds = 0
        self.cache_hits = 0
        self.inflight_joins = 0
        self.updates_verified = 0
        self.verify_failures = 0

    def note_served(self, *, hit: bool = False, joined: bool = False) -> None:
        with self._lock:
            self.served += 1
            self.cache_hits += bool(hit)
            self.inflight_joins += bool(joined)

    def note_build(self) -> None:
        with self._lock:
            self.builds += 1

    def note_verdict(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.updates_verified += 1
            else:
                self.verify_failures += 1

    @property
    def hit_rate(self) -> float:
        # joins count as hits: the artifact was NOT rebuilt for them
        with self._lock:
            if not self.served:
                return 0.0
            return (self.cache_hits + self.inflight_joins) / self.served

    def export_gauges(self) -> None:
        with self._lock:
            served, builds = self.served, self.builds
            joins = self.inflight_joins
            verified, failures = self.updates_verified, self.verify_failures
            rate = ((self.cache_hits + joins) / served) if served else 0.0
        profiling.set_gauge(self._served_label, served)
        profiling.set_gauge(self._builds_label, builds)
        profiling.set_gauge(self._joins_label, joins)
        profiling.set_gauge(self._verified_label, verified)
        profiling.set_gauge(self._verify_fail_label, failures)
        profiling.set_gauge(self._hit_rate_label, round(rate, 6))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(
                served=self.served, builds=self.builds,
                cache_hits=self.cache_hits,
                inflight_joins=self.inflight_joins,
                updates_verified=self.updates_verified,
                verify_failures=self.verify_failures,
                hit_rate=round(
                    ((self.cache_hits + self.inflight_joins) / self.served)
                    if self.served else 0.0, 6),
            )


class ProofService:
    """Deduplicating proof front: ``serve()`` returns the one artifact
    for ``(slot, state_root)``, building it at most once.

    ``verifier`` (the port's ``VerificationService``, or a ``FleetRouter``:
    the same ``submit`` contract) routes the artifact's sync-committee
    signature through the BLS fast path; the verdict lands
    on ``artifact.verified`` before the artifact is published to the
    cache, so joiners and later hits see a settled verdict.
    """

    def __init__(self, *, capacity: Optional[int] = None,
                 node: Optional[str] = None, verifier=None,
                 verify_timeout: Optional[float] = None,
                 recorder=None):
        if capacity is None:
            capacity = int(os.environ.get(CACHE_ENV, "1024"))
        if verify_timeout is None:
            verify_timeout = float(
                os.environ.get(VERIFY_TIMEOUT_ENV, "60"))
        self.node = node
        self.cache = ProofCache(capacity)
        self.metrics = ProofMetrics(node)
        self._verifier = verifier
        self._verify_timeout = verify_timeout
        self._recorder = (recorder if recorder is not None
                          else flight.maybe_recorder())
        self._lock = threading.Lock()
        self._pending: Dict[bytes, Future] = {}

    def serve(self, slot: int, state_root: bytes,
              build_fn: Callable[[], ProofArtifact]) -> ProofArtifact:
        t0 = time.perf_counter()
        key = proof_key(slot, state_root)
        with self._lock:
            artifact = self.cache.get(key)
            if artifact is None:
                fut = self._pending.get(key)
                if fut is None:
                    fut = Future()
                    self._pending[key] = fut
                    owner = True
                else:
                    owner = False
        if artifact is not None:
            self.metrics.note_served(hit=True)
            latency.note_stage("proof_serve", time.perf_counter() - t0)
            return artifact
        if not owner:
            artifact = fut.result(timeout=self._verify_timeout)
            self.metrics.note_served(joined=True)
            latency.note_stage("proof_serve", time.perf_counter() - t0)
            return artifact

        try:
            tb = time.perf_counter()
            artifact = build_fn()
            latency.note_stage("proof_build", time.perf_counter() - tb)
            self.metrics.note_build()
            self._verify(artifact)
        except BaseException as exc:
            with self._lock:
                self._pending.pop(key, None)
            fut.set_exception(exc)
            if self._recorder is not None:
                self._recorder.note(
                    "lightclient", "proof_build_failed", slot=int(slot),
                    error=repr(exc))
            raise
        with self._lock:
            self.cache.put(key, artifact)
            self._pending.pop(key, None)
        fut.set_result(artifact)
        if self._recorder is not None:
            self._recorder.note(
                "lightclient", "proof_build", slot=int(slot),
                key=key.hex()[:16], verified=artifact.verified)
        self.metrics.note_served()
        latency.note_stage("proof_serve", time.perf_counter() - t0)
        return artifact

    def _verify(self, artifact: ProofArtifact) -> None:
        if (self._verifier is None or artifact.update is None
                or not artifact.participant_pubkeys):
            return
        tv = time.perf_counter()
        fut = self._verifier.submit(
            "fast_aggregate",
            [bytes(pk) for pk in artifact.participant_pubkeys],
            bytes(artifact.signing_root),
            bytes(artifact.update.sync_committee_signature))
        artifact.verified = bool(fut.result(timeout=self._verify_timeout))
        latency.note_stage("proof_verify", time.perf_counter() - tv)
        self.metrics.note_verdict(artifact.verified)
        if not artifact.verified and self._recorder is not None:
            self._recorder.note(
                "lightclient", "proof_verify_failed",
                slot=int(artifact.slot))

    def export_gauges(self) -> None:
        self.metrics.export_gauges()

    def snapshot(self) -> Dict[str, float]:
        snap = self.metrics.snapshot()
        snap["cache_entries"] = len(self.cache)
        snap["pending"] = len(self._pending)
        return snap
