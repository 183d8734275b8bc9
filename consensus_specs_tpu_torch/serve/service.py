"""Continuous micro-batching verification service for the BLS plane: the
port's copy of consensus_specs_tpu/serve/service.py, on the port's
backend and its CUDA streams.

A live node has a STREAM of gossip aggregates arriving one at a time,
each wanting an answer under a latency deadline. The service batches
them continuously:

  submit() -> bounded ingress queue -> PREP stage forms a batch (flush on
  max_batch OR max_wait_ms OR, with CONSENSUS_SPECS_TPU_SLOT_MS arming a
  slot clock, the most urgent item's remaining slot budget minus the
  observed downstream p99, whichever first) and runs the input codec
  (ops/codec.py via prewarm_host_caches: batched decompression, subgroup
  checks, hash-to-G2) -> hand-off queue -> DEVICE stage verifies the
  flush with one RLC combined check (or one batched call per (kind, K
  bucket) group) -> futures resolve.

The two stages are a pipeline: while the device stage verifies micro-batch
N, the prep stage is already decoding and hashing micro-batch N+1. The
hand-off queue holds at most one prepped batch, so prep runs at most one
batch ahead and backpressure still reaches submit().

Device and streams: the service resolves ``device`` once at construction
(``None`` is the CUDA card and raises without one; ``"cpu"`` is the plain
path) and passes it to every backend call. On a CUDA device each stage
thread runs on a CUDA stream of its own, made at construction, so the
prep stage's kernels (and its chain-graph captures) and the device
stage's kernels are independent streams rather than both queued on the
legacy default stream. Nothing on the card crosses the hand-off queue:
the host caches hold numpy arrays and a batch is a list of requests.

Mesh: the service takes its verify mesh (``utils/torch_env.Mesh``) at
construction: an explicit ``mesh=`` wins, otherwise the process-level
provider (``torch_env.maybe_mesh``, governed by
CONSENSUS_SPECS_TPU_MESH; one env read when off). A 1-slot mesh
collapses to the unsharded path, and a flush narrower than the mesh runs
unsharded. A flush's RLC check and each group's first attempt run on the
mesh; a failure there costs one ``mesh_fallbacks`` and a
``degraded_mesh_to_single`` flight event, and the single-device path
answers (ladder rung 0).

Robustness: a device error on a flush is retried once (transient); an
RLC failure then moves the flush to the per-group batched path (its own
retry), and a per-group failure degrades the group to the pure-Python
oracle item by item: a poisoned batch costs latency, never correctness,
and never a lost request. Every step is counted (``ServeMetrics``,
``serve.rlc_error`` / ``serve.backend_error`` records) and journaled by
the flight recorder. Duplicate content (the same aggregate from many
gossip peers) is answered by the result LRU or, while still in flight,
by sharing the first submitter's Future (``cache.py``): the backend sees
each distinct check exactly once.

Observability: every accepted submit can carry a per-request span trace
(queue_wait / prep / device / combine / finalize, ``obs/tracing.py``,
opt-in via CONSENSUS_SPECS_TPU_TRACE=1 or an explicit ``tracer=``); the
counters in metrics.py export through ``ops/profiling``. With tracing
off the service stores None and every stage skips on one ``is not None``
check.
"""
import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import torch

from ..device import resolve_device
from ..obs import devices, flight, latency, tracing
from ..ops import profiling
from ..utils import torch_env
from .cache import ResultCache, check_key
from .metrics import ServeMetrics

KINDS = ("fast_aggregate", "aggregate")

# slot duration in milliseconds arming the deadline-aware flush scheduler:
# unset/0 keeps the classic size-OR-deadline flush; set, every
# submit without an explicit deadline inherits "the end of the current
# slot", and _collect flushes early when the remaining budget minus the
# observed downstream p99 would otherwise be blown
SLOT_MS_ENV = "CONSENSUS_SPECS_TPU_SLOT_MS"


class SlotClock:
    """Wall-clock slot grid for deadline-aware flushing.

    The grid is anchored at ``origin`` (construction time by default) and
    ticks every ``slot_s`` seconds; ``slot_end(t)`` is the absolute
    perf-counter time the slot containing ``t`` closes: the latency
    budget a gossip item born at ``t`` has. One clock can be shared by
    many services (reads only)."""

    __slots__ = ("slot_s", "origin", "_clock")

    def __init__(self, slot_s: float, clock=time.perf_counter,
                 origin: Optional[float] = None):
        assert slot_s > 0
        self.slot_s = float(slot_s)
        self._clock = clock
        self.origin = clock() if origin is None else origin

    @classmethod
    def from_env(cls) -> Optional["SlotClock"]:
        """A clock from ``CONSENSUS_SPECS_TPU_SLOT_MS``; None when unset,
        zero, or malformed (a typo'd slot must degrade to the classic
        flush rule, never crash service construction)."""
        raw = (os.environ.get(SLOT_MS_ENV) or "").strip()
        if not raw:
            return None
        try:
            ms = float(raw)
        except ValueError:
            return None
        return cls(ms / 1e3) if ms > 0 else None

    def slot_index(self, t: Optional[float] = None) -> int:
        if t is None:
            t = self._clock()
        return int((t - self.origin) // self.slot_s)

    def slot_end(self, t: Optional[float] = None) -> float:
        """Absolute time the slot containing ``t`` closes."""
        if t is None:
            t = self._clock()
        return self.origin + (self.slot_index(t) + 1) * self.slot_s

    def remaining(self, t: Optional[float] = None) -> float:
        if t is None:
            t = self._clock()
        return self.slot_end(t) - t


def _rlc_enabled() -> bool:
    """Micro-batches route through the backend's RLC combine path (one
    final exponentiation per flush) unless CONSENSUS_SPECS_TPU_RLC=0
    reverts to per-(kind, K-bucket) per-item finalization; the backend's
    ``rlc_enabled`` is the one reader of that variable."""
    from ..ops.bls_backend import rlc_enabled

    return rlc_enabled()


class ServiceClosed(RuntimeError):
    """submit() after close(): the stream has been drained and ended."""


class QueueFull(RuntimeError):
    """Backpressure deadline expired while the ingress queue stayed full."""


class _Pending:
    __slots__ = ("kind", "pubkeys", "messages", "signature", "key",
                 "bucket", "future", "t_submit", "trace", "deadline")

    def __init__(self, kind, pubkeys, messages, signature, key, bucket,
                 future, t_submit, trace=None, deadline=None):
        self.kind = kind
        self.pubkeys = pubkeys
        self.messages = messages
        self.signature = signature
        self.key = key
        self.bucket = bucket
        self.future = future
        self.t_submit = t_submit
        self.trace = trace  # obs.tracing.RequestTrace, or None (tracing off)
        # absolute perf-counter time this item must have reached the head
        # by (slot-clock-derived or caller-supplied); None = no budget
        self.deadline = deadline


class _CapturedOracle:
    """The pure-Python per-item fallback, captured eagerly from the port's
    switchboard (``utils/bls.py``) at construction: its ``oracle_*``
    functions, which never dispatch to the card whatever the switch
    says, so the last rung cannot call the failing card path again."""

    def __init__(self, fast_aggregate_verify, aggregate_verify):
        self.fast_aggregate_verify = fast_aggregate_verify
        self.aggregate_verify = aggregate_verify

    def verify_one(self, p: _Pending) -> bool:
        if p.kind == "fast_aggregate":
            return bool(self.fast_aggregate_verify(p.pubkeys, p.messages,
                                                   p.signature))
        return bool(self.aggregate_verify(p.pubkeys, p.messages, p.signature))


class VerificationService:
    """Streaming front of the batched BLS backend.

    ``submit(kind, pubkeys, messages, signature) -> Future[bool]``; see
    the module docstring for the dataflow. Use as a context manager, or
    call ``close()`` — close drains: every accepted request resolves.
    """

    def __init__(self, backend=None, oracle=None, *, device=None,
                 max_batch: int = 256, max_wait_ms: float = 20.0,
                 max_queue: int = 4096, cache_capacity: int = 1 << 16,
                 backend_retries: int = 1, bucket_fn=None, tracer=None,
                 node=None, slot_clock=None, deadline_margin_ms: float = 2.0,
                 mesh=None):
        assert max_batch > 0 and max_queue > 0
        self._backend = backend  # None: resolved lazily on first batch
        # resolved once: None is the CUDA card (raises without one)
        self._device = resolve_device(device)
        # the verify mesh, acquired here: an explicit ``mesh=`` wins,
        # otherwise the process-level provider (CONSENSUS_SPECS_TPU_MESH);
        # a 1-slot mesh is the unsharded path
        if mesh is None:
            mesh = torch_env.maybe_mesh(self._device)
        self._mesh = mesh
        self._mesh_devices = 0 if mesh is None else mesh.size
        if self._mesh_devices <= 1:
            self._mesh = None
            self._mesh_devices = 0
        # one CUDA stream per stage thread on a CUDA device (None on the
        # CPU, where torch.cuda.stream(None) is a no-op)
        cuda = self._device.type == "cuda"
        self._prep_stream = torch.cuda.Stream(self._device) if cuda else None
        self._device_stream = (torch.cuda.Stream(self._device) if cuda
                               else None)
        # deadline-aware flush scheduling: an explicit ``slot_clock=``
        # wins; otherwise the env-armed grid (CONSENSUS_SPECS_TPU_SLOT_MS;
        # None when unset keeps the classic size-OR-deadline flush). The
        # margin covers scheduling jitter between "flush fires" and
        # "verdict lands".
        self._slot_clock = (slot_clock if slot_clock is not None
                            else SlotClock.from_env())
        self._deadline_margin_s = max(0.0, deadline_margin_ms) / 1e3
        # per-request span tracing (obs/tracing.py): an explicit tracer
        # wins; otherwise the global tracer iff CONSENSUS_SPECS_TPU_TRACE
        # is set AT CONSTRUCTION. Disabled == None: every stage guards on
        # one `is not None`.
        self._tracer = tracer if tracer is not None else tracing.maybe_tracer()
        # flight recorder + device-occupancy ledger (obs/flight.py,
        # obs/devices.py), captured at construction like the tracer:
        # disabled == None, every site guards on `is not None`
        self._flight = flight.maybe_recorder()
        self._devices = devices.maybe_ledger()
        if oracle is None:
            from ..utils import bls

            oracle = _CapturedOracle(bls.oracle_fast_aggregate_verify,
                                     bls.oracle_aggregate_verify)
        self._oracle = oracle
        if bucket_fn is None:
            from ..ops.bls_backend import _k_bucket as bucket_fn
        self._bucket_fn = bucket_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._max_queue = max_queue
        self._backend_retries = max(0, backend_retries)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)      # queue gained items / closing
        self._not_full = threading.Condition(self._lock)  # queue lost items
        self._queue: "deque[_Pending]" = deque()
        # requests pulled by the prep stage but not yet taken by the
        # device stage: counted against max_queue so the pipeline's
        # look-ahead cannot widen the backpressure bound
        self._staged = 0
        self._inflight = {}  # key -> _Pending (queued or mid-batch)
        self._cache = ResultCache(cache_capacity)
        # node labels the whole metric family (serve[<node>].<name>) so N
        # instances coexist in one process
        self.metrics = ServeMetrics(node=node)
        self.metrics.note_mesh(self._mesh_devices)  # 0: single-device
        # commanded degradation-ladder rung (load shedding): 0 = normal
        # (RLC combine first), 1 = per-group batched only, 2 = sequential
        # oracle only, moved by set_ladder_rung; the fault-driven
        # degradations below are orthogonal (they fall DOWN from whatever
        # rung is commanded).
        self._ladder_rung = 0
        self.metrics.note_ladder(0)
        self._closed = False
        # two-stage pipeline: prep(N+1) overlaps device(N) through a
        # one-slot hand-off queue
        self._handoff: "queue.Queue[Optional[List[_Pending]]]" = queue.Queue(
            maxsize=1
        )
        self._worker = threading.Thread(
            target=self._on_stream(self._prep_stream, self._run),
            name="verification-service-prep", daemon=True,
        )
        self._device_worker = threading.Thread(
            target=self._on_stream(self._device_stream, self._device_run),
            name="verification-service-device", daemon=True,
        )
        self._worker.start()
        self._device_worker.start()

    # -- ingress ------------------------------------------------------------

    def submit(self, kind: str, pubkeys, messages, signature,
               timeout: Optional[float] = None, *,
               birth_s: Optional[float] = None,
               flow_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> "Future[bool]":
        """Enqueue one verification; returns a Future resolving to bool.

        The reference's no-crypto rules are answered eagerly, exactly as
        the switchboard would (reference utils/bls.py:47-74): empty pubkey
        sets and pubkey/message length mismatches are False; stub mode
        (``bls_active`` off) is True. Everything else is batched.

        Backpressure: when the ingress queue is full, submit blocks until
        space frees (bounded by ``timeout`` seconds -> QueueFull).

        ``birth_s`` is the item's gossip-arrival perf-counter timestamp
        (records the ``ingress`` stage and, with tracing on, an ingress
        span); ``flow_id`` is its end-to-end trace id (a Chrome flow link
        from this request's span row); ``deadline_s`` is an absolute
        deadline (defaulted to the end of the current slot when a slot
        clock is armed) that the flush scheduler budgets against.
        """
        from ..utils import bls

        t0 = time.perf_counter()
        if kind not in KINDS:
            raise ValueError(f"unknown check kind {kind!r}")
        if birth_s is not None:
            latency.note_stage("ingress", max(0.0, t0 - birth_s))
        if deadline_s is None and self._slot_clock is not None:
            deadline_s = self._slot_clock.slot_end(t0)
        self.metrics.note_submit()
        fut: "Future[bool]" = Future()
        if not bls.bls_active:
            self.metrics.note_eager()
            fut.set_result(True)
            return fut
        pubkeys = [bytes(pk) for pk in pubkeys]
        signature = bytes(signature)
        if kind == "fast_aggregate":
            messages = bytes(messages)
            if len(pubkeys) == 0:
                self.metrics.note_eager()
                fut.set_result(False)
                return fut
        else:
            messages = [bytes(m) for m in messages]
            if len(pubkeys) == 0 or len(pubkeys) != len(messages):
                self.metrics.note_eager()
                fut.set_result(False)
                return fut
        key = check_key(kind, pubkeys, messages, signature)

        with self._lock:
            deadline = None if timeout is None else t0 + timeout
            # dedup and space checks live in ONE loop: a backpressure wait
            # releases the lock, so identical content may complete (cache)
            # or enqueue (in-flight) while we block — re-checking after
            # every wakeup keeps the verified-exactly-once invariant
            while True:
                if self._closed:
                    raise ServiceClosed(
                        "submit() on a closed VerificationService"
                    )
                hit = self._cache.get(key)
                if hit is not None:
                    self.metrics.note_cache_hit()
                    self.metrics.note_result(time.perf_counter() - t0)
                    if self._flight is not None:
                        self._flight.note("serve", "cache_hit",
                                          check_kind=kind)
                    fut.set_result(hit)
                    return fut
                pend = self._inflight.get(key)
                if pend is not None:
                    # same content already queued/verifying: share its Future
                    self.metrics.note_inflight_join()
                    if self._flight is not None:
                        self._flight.note("serve", "dedup_join",
                                          check_kind=kind)
                    return pend.future
                if len(self._queue) + self._staged < self._max_queue:
                    break
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise QueueFull(
                        f"ingress queue held {self._max_queue} requests for "
                        f"{timeout}s"
                    )
                self._not_full.wait(remaining)
            tr = (self._tracer.begin(kind, len(pubkeys), t0, flow=flow_id)
                  if self._tracer is not None else None)
            if tr is not None and birth_s is not None:
                self._tracer.span(tr, "ingress", birth_s, t0)
            pend = _Pending(kind, pubkeys, messages, signature, key,
                            self._bucket_fn(max(1, len(pubkeys))), fut, t0,
                            tr, deadline=deadline_s)
            self._queue.append(pend)
            self._inflight[key] = pend
            self.metrics.note_enqueued(len(self._queue))
            self._work.notify()
        return fut

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting submissions and drain: blocks until the worker
        has resolved every accepted request and exited."""
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._not_full.notify_all()
        self._worker.join(timeout)
        self._device_worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def cache(self) -> ResultCache:
        return self._cache

    @property
    def mesh_devices(self) -> int:
        """Slots the verify mesh spans (0 = single-device path)."""
        return self._mesh_devices

    @property
    def slot_clock(self) -> Optional[SlotClock]:
        """The armed slot grid (None = classic size-OR-deadline flush)."""
        return self._slot_clock

    @property
    def ladder_rung(self) -> int:
        """The commanded degradation rung (0 RLC / 1 per-group / 2 oracle)."""
        return self._ladder_rung

    def set_ladder_rung(self, rung: int, reason: Optional[str] = None) -> None:
        """Command the service onto a degradation-ladder rung, the load-
        shedding control surface. Takes effect from the next flush; every
        transition is journaled (``shed_rung``)."""
        rung = max(0, min(2, int(rung)))
        with self._lock:
            prev, self._ladder_rung = self._ladder_rung, rung
        if prev != rung:
            self.metrics.note_ladder(rung)
            if self._flight is not None:
                self._flight.note("serve", "shed_rung", rung_from=prev,
                                  rung_to=rung, reason=reason)

    def _flush_mesh(self, n_items: int):
        """The mesh for an n_items flush, or None when the batch is
        narrower than the slot count: its rows would pad up to the mesh
        and run mostly filler, while the single-device programs are
        already warm. Verdicts are equal either way."""
        if self._mesh is not None and n_items >= self._mesh_devices:
            return self._mesh
        return None

    # -- worker -------------------------------------------------------------

    @staticmethod
    def _on_stream(stream, fn):
        """``fn`` run inside ``torch.cuda.stream(stream)``: a stage
        thread's kernels go to its own stream (no-op for None)."""
        def run():
            with torch.cuda.stream(stream):
                fn()
        return run

    def _resolve_backend(self):
        if self._backend is None:
            from ..ops import bls_backend

            self._backend = bls_backend
        return self._backend

    def _run(self):
        """PREP stage: collect a micro-batch, run the input codec on it,
        hand it to the device stage. While the device stage verifies
        batch N this loop is already prepping batch N+1."""
        while True:
            batch = self._collect()
            if batch is None:
                self._handoff.put(None)  # drain sentinel
                return
            t0 = time.perf_counter()
            try:
                self._prep(batch)
            except Exception:
                # prep is a throughput optimization only: the device
                # stage's per-item cache misses re-derive (and re-raise)
                # whatever prep could not produce
                profiling.record("serve.prep_error", 0.0)
                if self._flight is not None:
                    self._flight.note("serve", "prep_error",
                                      items=len(batch))
            t1 = time.perf_counter()
            self.metrics.note_prep(t1 - t0)
            latency.note_stage("prep", t1 - t0)
            if self._devices is not None:
                # the prep stage's codec time on the dedicated host lane:
                # the occupancy timeline then shows the pipeline overlap
                # (host busy on batch N+1 while a device lane is busy on
                # batch N)
                self._devices.note_busy(devices.HOST_LANE, t0, t1,
                                        label="prep")
            if self._tracer is not None:
                self._tracer.span_many((p.trace for p in batch), "prep",
                                       t0, t1)
            self._handoff.put(batch)

    def _prep(self, batch: List[_Pending]) -> None:
        """Warm the backend's host caches for the whole micro-batch with
        the batched input codec (decompression, subgroup checks and
        hash-to-G2 in array-wide passes) on the service's device."""
        backend = self._resolve_backend()
        prewarm = getattr(backend, "prewarm_host_caches", None)
        if prewarm is None:
            return  # oracle-only / test backends have no host caches
        msgs: List[bytes] = []
        sigs: List[bytes] = []
        pks: List[bytes] = []
        for p in batch:
            if p.kind == "fast_aggregate":
                msgs.append(p.messages)
            else:
                msgs.extend(p.messages)
            sigs.append(p.signature)
            pks.extend(p.pubkeys)
        prewarm(msgs, sigs, pks, device=self._device)

    def _device_run(self):
        """DEVICE stage: drain prepped batches and verify them."""
        while True:
            batch = self._handoff.get()
            if batch is None:
                return
            with self._lock:
                self._staged -= len(batch)
                self._not_full.notify_all()
            try:
                self._process(batch)
            except Exception as e:
                # belt-and-braces: _process guards each group; whatever
                # still leaks must not kill the stream — resolve the
                # batch through the oracle, item by item
                profiling.record("serve.device_stage_error", 0.0)
                self._note_oracle_fault("device_stage_error", e,
                                        items=len(batch))
                self._resolve_sequential(
                    [p for p in batch if not p.future.done()]
                )

    def _budget_deadline_locked(self,
                                downstream_s: float) -> Optional[float]:
        """The slot-budget flush deadline: the earliest queued item's
        head-by deadline minus the observed p99 of the stages it still
        has to pay (prep/device/finalize) minus the margin. None when no
        queued item carries a deadline (the classic flush rule alone
        governs). Called under the service lock."""
        earliest = None
        for p in self._queue:
            if p.deadline is not None and (earliest is None
                                           or p.deadline < earliest):
                earliest = p.deadline
        if earliest is None:
            return None
        return earliest - downstream_s - self._deadline_margin_s

    def _collect(self) -> Optional[List[_Pending]]:
        """Block for work, then gather one batch: flush when ``max_batch``
        requests are waiting OR ``max_wait_ms`` has passed since the
        OLDEST waiting request was submitted OR (with a slot clock armed)
        the remaining slot budget of the most urgent queued
        item, minus the live downstream p99, is about to be blown,
        whichever comes first. Returns None when closed and fully
        drained."""
        # downstream p99 read OUTSIDE the service lock (it takes the
        # profiling/histogram locks); refreshed once per collect — the
        # number moves at flush cadence, not per wakeup
        downstream_s = (latency.downstream_p99_s()
                        if self._slot_clock is not None else 0.0)
        deadline_flush = False
        budget_remaining = 0.0
        with self._lock:
            while not self._queue:
                if self._closed:
                    return None
                self._work.wait()
            deadline = self._queue[0].t_submit + self._max_wait_s
            while len(self._queue) < self._max_batch and not self._closed:
                budget = (self._budget_deadline_locked(downstream_s)
                          if self._slot_clock is not None else None)
                effective = (deadline if budget is None
                             else min(deadline, budget))
                now = time.perf_counter()
                if effective - now <= 0:
                    if budget is not None and budget < deadline:
                        # the slot budget — not size, not max_wait —
                        # fired this flush
                        deadline_flush = True
                        budget_remaining = max(0.0, budget - now)
                    break
                self._work.wait(effective - now)
            n = min(self._max_batch, len(self._queue))
            batch = [self._queue.popleft() for _ in range(n)]
            self._staged += n
            profiling.set_gauge("serve.queue_depth", len(self._queue))
        now = time.perf_counter()
        for p in batch:
            latency.note_stage("queue_wait", now - p.t_submit)
        if deadline_flush:
            self.metrics.note_deadline_flush(budget_remaining * 1e3)
            if self._flight is not None:
                self._flight.note(
                    "serve", "deadline_flush", items=len(batch),
                    budget_ms=round(budget_remaining * 1e3, 3),
                    downstream_p99_ms=round(downstream_s * 1e3, 3))
        if self._tracer is not None:
            for p in batch:
                if p.trace is not None:
                    self._tracer.span(p.trace, "queue_wait", p.t_submit, now)
        return batch

    def _process(self, batch: List[_Pending]) -> None:
        groups = {}
        for p in batch:
            groups.setdefault((p.kind, p.bucket), []).append(p)
        if self._flight is not None:
            self._flight.note("serve", "flush", items=len(batch),
                              groups=len(groups))
        t_flush = time.perf_counter()
        results = self._verify_rlc(batch)
        if results is not None:
            # ONE combined check decided the whole micro-batch; attribute
            # the flush time to its (kind, K-bucket) groups by item share
            # so occupancy/batch accounting stays per-group
            dt = time.perf_counter() - t_flush
            for (kind, bucket), pends in groups.items():
                self.metrics.note_batch(
                    len(pends), sum(len(p.pubkeys) for p in pends), bucket,
                    dt * len(pends) / len(batch),
                )
            if self._tracer is not None:
                self._tracer.span_many((p.trace for p in batch), "device",
                                       t_flush, t_flush + dt)
            self._settle(batch, results)
        else:
            for (kind, bucket), pends in groups.items():
                t0 = time.perf_counter()
                results = self._verify_group(kind, pends)
                t1 = time.perf_counter()
                self.metrics.note_batch(
                    len(pends), sum(len(p.pubkeys) for p in pends), bucket,
                    t1 - t0,
                )
                if self._tracer is not None:
                    self._tracer.span_many((p.trace for p in pends),
                                           "device", t0, t1)
                self._settle(pends, results)
        # whole-flush device time (all groups): the prep/device split is
        # per FLUSH on both sides, so the means share a denominator shape
        device_s = time.perf_counter() - t_flush
        self.metrics.note_device_flush(device_s)
        latency.note_stage("device", device_s)
        self.metrics.export_gauges()

    def _verify_rlc(self, batch: List[_Pending]) -> Optional[List[bool]]:
        """Whole-micro-batch RLC verification (backend.batch_verify_rlc:
        one easy part + one hard part for the flush, bisection localizes
        failures). Returns None to fall back to the per-group path — when
        the env reverts it, the backend has no RLC entry point, or every
        bounded retry failed (the per-group path then brings its own
        retry-then-oracle ladder, so an RLC-specific fault — e.g. a
        combine-program compile error — still degrades in two steps
        instead of straight to the sequential oracle)."""
        if self._ladder_rung >= 1:
            return None  # shed: the per-group (or oracle) path serves
        backend = self._resolve_backend()
        rlc_fn = getattr(backend, "batch_verify_rlc", None)
        if rlc_fn is None or not _rlc_enabled():
            return None
        items = [(p.kind, p.pubkeys, p.messages, p.signature) for p in batch]
        flush_mesh = self._flush_mesh(len(batch))
        if flush_mesh is not None:
            # degradation-ladder rung 0: the mesh-sharded combined check.
            # A failure here costs one fallback, never the flush: the
            # single-device RLC below still amortizes the final exp
            try:
                t0 = time.perf_counter()
                res = [bool(r) for r in rlc_fn(items, device=self._device,
                                               mesh=flush_mesh)]
                t1 = time.perf_counter()
                latency.note_stage("combine", t1 - t0)
                if self._tracer is not None:
                    self._tracer.span_many((p.trace for p in batch),
                                           "combine", t0, t1)
                return res
            except Exception as e:
                self.metrics.note_mesh_fallback()
                if self._flight is not None:
                    self._flight.note(
                        "serve", "degraded_mesh_to_single",
                        items=len(batch), devices=self._mesh_devices,
                        error=f"{type(e).__name__}: {e}"[:200])
        for attempt in range(1 + self._backend_retries):
            if attempt:
                self.metrics.note_retry()
                if self._flight is not None:
                    self._flight.note("serve", "backend_retry",
                                      stage="rlc", attempt=attempt,
                                      items=len(batch))
            try:
                t0 = time.perf_counter()
                res = [bool(r) for r in rlc_fn(items, device=self._device)]
                t1 = time.perf_counter()
                # the RLC combined check (bisection included when the
                # combine failed and split) — nests inside `device`
                latency.note_stage("combine", t1 - t0)
                if self._tracer is not None:
                    self._tracer.span_many((p.trace for p in batch),
                                           "combine", t0, t1)
                return res
            except Exception:
                pass
        profiling.record("serve.rlc_error", 0.0)
        if self._flight is not None:
            # degradation-ladder rung 1: the whole-flush RLC combine gave
            # up; the per-group path (its own retry-then-oracle ladder)
            # takes over
            self._flight.note("serve", "degraded_rlc_to_groups",
                              items=len(batch))
        return None

    def _verify_group(self, kind: str, pends: List[_Pending]) -> List[bool]:
        if self._ladder_rung >= 2:
            # commanded to the bottom rung: answer sequentially through
            # the oracle — correct and load-free on the device plane
            self.metrics.note_fallback(len(pends))
            return [self._oracle_one(p) for p in pends]
        backend = self._resolve_backend()
        # a backend that declares ``wants_flow_context`` gets each item's
        # Chrome flow id alongside the batch, so its own spans can join the
        # flows this service's traces carry
        wants_flows = bool(getattr(backend, "wants_flow_context", False))
        last_err = None
        for attempt in range(1 + self._backend_retries):
            if attempt:
                self.metrics.note_retry()
                if self._flight is not None:
                    self._flight.note("serve", "backend_retry",
                                      stage="group", attempt=attempt,
                                      check_kind=kind, items=len(pends))
            # attempt 0 rides the mesh when one is armed (and the group is
            # at least mesh-wide); retries drop to the single-device path,
            # so a mesh fault degrades in one rung
            kwargs = {"device": self._device}
            group_mesh = self._flush_mesh(len(pends)) if attempt == 0 else None
            if group_mesh is not None:
                kwargs["mesh"] = group_mesh
            if wants_flows:
                kwargs["flows"] = [
                    None if p.trace is None else p.trace.flow
                    for p in pends]
            try:
                if kind == "fast_aggregate":
                    res = backend.batch_fast_aggregate_verify(
                        [p.pubkeys for p in pends],
                        [p.messages for p in pends],
                        [p.signature for p in pends],
                        **kwargs,
                    )
                else:
                    res = backend.batch_aggregate_verify(
                        [p.pubkeys for p in pends],
                        [p.messages for p in pends],
                        [p.signature for p in pends],
                        **kwargs,
                    )
                return [bool(r) for r in res]
            except Exception as e:  # device/compile/transfer failure
                last_err = e
                if group_mesh is not None:
                    self.metrics.note_mesh_fallback()
                    if self._flight is not None:
                        self._flight.note(
                            "serve", "degraded_mesh_to_single",
                            stage="group", check_kind=kind,
                            items=len(pends), devices=self._mesh_devices,
                            error=f"{type(e).__name__}: {e}"[:200])
        # poisoned batch: degrade to sequential oracle verification —
        # the stream slows down, it does not fail
        profiling.record("serve.backend_error", 0.0)
        # degradation-ladder rung 2 (the bottom): this is the fault a
        # post-mortem wants
        self._note_oracle_fault("degraded_to_oracle", last_err,
                                dump="serve_backend_degraded_to_oracle",
                                check_kind=kind, items=len(pends))
        del last_err
        self.metrics.note_fallback(len(pends))
        return [self._oracle_one(p) for p in pends]

    def _note_oracle_fault(self, kind: str, err, dump: str = "",
                           **data) -> None:
        """A fault sent items to the pure-Python oracle. On a CUDA service
        that means the card path failed, so the transition is journalled
        whether or not the flight recorder is on (in the process-wide
        ring when it is off), dumped when it is on, and warned about on
        a CUDA device: no run that depends on the card passes through
        this rung unseen."""
        error = (f"{type(err).__name__}: {err}"[:200]
                 if err is not None else None)
        recorder = (self._flight if self._flight is not None
                    else flight.global_recorder())
        recorder.note("serve", kind, error=error, **data)
        if self._flight is not None:
            self._flight.dump_on_fault(dump or f"serve_{kind}")
        if self._device.type == "cuda":
            warnings.warn(
                f"serve: {data.get('items')} items went to the pure-Python "
                f"oracle on the CPU because the card path failed ({kind}: "
                f"{error})", RuntimeWarning, stacklevel=2)

    def _oracle_one(self, p: _Pending) -> bool:
        try:
            return self._oracle.verify_one(p)
        except Exception:
            return False  # the switchboard's exception-swallowing contract

    def _resolve_sequential(self, pends: List[_Pending]) -> None:
        self.metrics.note_fallback(len(pends))
        self._settle(pends, [self._oracle_one(p) for p in pends])

    def _settle(self, pends: List[_Pending], results: List[bool]) -> None:
        now = time.perf_counter()
        with self._lock:
            for p, r in zip(pends, results):
                self._cache.put(p.key, bool(r))
                self._inflight.pop(p.key, None)
        for p, r in zip(pends, results):
            self.metrics.note_result(now - p.t_submit)
            if not p.future.done():
                p.future.set_result(bool(r))
        t_end = time.perf_counter()
        latency.note_stage("finalize", t_end - now)
        if self._tracer is not None:
            for p, r in zip(pends, results):
                if p.trace is not None:
                    self._tracer.span(p.trace, "finalize", now, t_end)
                    self._tracer.finish(p.trace, bool(r), t_end)
