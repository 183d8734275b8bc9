"""Fleet router: N worker processes, one merged observability surface,
SLO-burn-driven load shedding (the port's counterpart of
consensus_specs_tpu/serve/fleet.py).

The router spawns one ``serve/worker.py`` process per worker, routes
every check by **consistent-hash content key** (the same aggregate heard
from many peers always lands on the same worker, so its result cache and
in-flight dedup keep answering: affinity is what makes per-worker caches
fleet-correct), and the observability plane is the thing that RUNS the
fleet:

- every control tick pulls an ``obs/snapshot.py`` wire snapshot from each
  worker and merges it exactly in the ``obs/fleet.FleetAggregator``
  (histogram bucket counts sum, stats sum, ``serve[<worker>].*``
  namespacing): one fleet-wide ``/metrics``, ``/healthz`` and
  ``/flightdump`` through ``obs/exposition.py`` overrides;
- ``obs/slo.py`` burn rates are computed on the MERGED histograms (the
  fleet's error budget, not any one process's), attributed per worker,
  and fed through the ``ShedPolicy``: a burning window sheds the worst
  worker one rung down the RLC -> per-group -> oracle degradation ladder
  (``VerificationService.set_ladder_rung``) or drains it from the ring.
  Every decision is journaled as a fleet flight event with worker
  provenance, and the commanded rung transition lands in the worker's
  own journal: the merged journal reconstructs decision -> command ->
  transition end to end.

Devices: ``FleetRouter(device=None)`` resolves the device by the port's
rule (the CUDA card, raising without one; ``device="cpu"`` for the plain
versions) and hands it to every worker through
``CONSENSUS_SPECS_TPU_FLEET_DEVICE``. Workers are fresh interpreters
(``Popen``, never ``fork``): each opens its own CUDA context on the card.
On the card, the router builds the kernel libraries once
(``ops/cuda_build.build``) before it spawns ``bls`` workers, so the
workers load them instead of each running ``nvcc``.

Hold-down: burn windows look back past an action (the bad mass that
justified a shed stays in the window for up to 300 s), so after acting
on a worker the router suppresses further actions on it for
``CONSENSUS_SPECS_TPU_FLEET_HOLDDOWN_S`` (default 30): one decision, then
re-measure.
"""
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from bisect import bisect_left
from concurrent.futures import Future
from typing import Dict, List, Optional

from ..device import resolve_device
from ..obs import flight
from ..obs.fleet import FleetAggregator
from ..obs.slo import ShedPolicy, SloTracker
from ..ops import profiling
from .cache import check_key

# the worker's env names are imported where a worker is spawned, never at
# module level: ``python -m ...serve.worker`` imports this package first,
# and a module-level import of .worker would load it a second time

# the directory that holds the package: put on every worker's PYTHONPATH
# so a worker imports the same copy of the port as its router
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HOLDDOWN_ENV = "CONSENSUS_SPECS_TPU_FLEET_HOLDDOWN_S"
DEFAULT_HOLDDOWN_S = 30.0
PIN_ENV = "CONSENSUS_SPECS_TPU_FLEET_PIN"


def _core_slices(n_workers: int):
    """Worker index -> csv core slice: the host's cores dealt round-robin
    across workers (worker i owns cores {c : c mod n == i}); one worker
    owns everything, more workers than cores timeshare one core each.
    Without this, N intra-op thread pools oversubscribe the host N-fold
    (the JAX package measured BELOW single-process throughput at 2
    workers on 2 cores)."""
    ncores = os.cpu_count() or 1
    if n_workers <= 1:
        return [None] * max(1, n_workers)
    slices = []
    for i in range(n_workers):
        cores = [c for c in range(ncores) if c % n_workers == i]
        if not cores:
            cores = [i % ncores]
        slices.append(",".join(str(c) for c in cores))
    return slices


class WorkerProtocolError(RuntimeError):
    """A worker answered wrongly, died, or timed out on the protocol."""


def _point(label: str, replica: int) -> int:
    h = hashlib.sha256(f"{label}:{replica}".encode()).digest()
    return int.from_bytes(h[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual points per worker.

    Routing is the classic rule: a key goes to the first point clockwise
    from its hash. Removing a worker (a drain) re-homes ONLY that
    worker's arc — every other worker keeps its keys, so their result
    caches stay warm through fleet membership changes."""

    def __init__(self, points_per_worker: int = 64):
        assert points_per_worker > 0
        self._ppw = points_per_worker
        # ONE atomically-swapped (points, owners) pair: membership changes
        # (a drain) race submit threads' route() calls, and a single
        # attribute assignment is the whole synchronization story
        self._table = ([], [])  # (sorted hash points, parallel owner labels)

    def add(self, label: str) -> None:
        points, owners = (list(self._table[0]), list(self._table[1]))
        for r in range(self._ppw):
            p = _point(label, r)
            i = bisect_left(points, p)
            points.insert(i, p)
            owners.insert(i, label)
        self._table = (points, owners)

    def remove(self, label: str) -> None:
        keep = [(p, o) for p, o in zip(*self._table) if o != label]
        self._table = ([p for p, _ in keep], [o for _, o in keep])

    def __len__(self) -> int:
        return len(set(self._table[1]))

    def route(self, key: bytes) -> str:
        points, owners = self._table
        if not points:
            raise WorkerProtocolError("no live workers in the ring")
        h = int.from_bytes(hashlib.sha256(key).digest()[:8], "big")
        i = bisect_left(points, h)
        if i == len(points):
            i = 0
        return owners[i]


class WorkerHandle:
    """One spawned worker process + its protocol plumbing.

    A reader thread drains the worker's stdout: ``result`` lines resolve
    submit futures (completion order), everything else resolves the RPC
    future its ``id`` names. Worker death fails every outstanding future:
    the router's caller sees an exception, never a hang. The worker's
    stderr is the parent's."""

    def __init__(self, label: str, env: Optional[Dict[str, str]] = None,
                 backend: str = "bls"):
        from .worker import BACKEND_ENV, WORKER_ENV

        self.label = label
        full_env = os.environ.copy()
        full_env.update(env or {})
        full_env[WORKER_ENV] = label
        full_env[BACKEND_ENV] = backend
        path = full_env.get("PYTHONPATH")
        full_env["PYTHONPATH"] = (_PKG_PARENT if not path
                                  else _PKG_PARENT + os.pathsep + path)
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "consensus_specs_tpu_torch.serve.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1, env=full_env)
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._next_id = 0
        self._results: Dict[int, Future] = {}   # submit id -> Future[bool]
        self._rpcs: Dict[int, Future] = {}      # rpc id -> Future[dict]
        self.ready = threading.Event()
        self.said_bye = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"fleet-worker-{label}-reader",
            daemon=True)
        self._reader.start()

    # -- wire ----------------------------------------------------------------

    def _send(self, obj: Dict) -> None:
        line = json.dumps(obj, separators=(",", ":"))
        try:
            with self._send_lock:
                self._proc.stdin.write(line + "\n")
                self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            self._fail_outstanding(f"worker {self.label} pipe: {e}")
            raise WorkerProtocolError(
                f"worker {self.label} unreachable: {e}") from e

    def _read_loop(self) -> None:
        for line in self._proc.stdout:
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # stray non-protocol line
            op = msg.get("op")
            if op == "ready":
                self.ready.set()
            elif op == "bye":
                self.said_bye.set()
            elif op == "result":
                fut = self._pop(self._results, msg.get("id"))
                if fut is not None:
                    fut.set_result(bool(msg.get("ok")))
            elif op in ("snapshot", "ok", "error"):
                fut = self._pop(self._rpcs, msg.get("id"))
                if fut is not None:
                    if op == "error":
                        fut.set_exception(WorkerProtocolError(
                            f"worker {self.label}: {msg.get('error')}"))
                    else:
                        fut.set_result(msg)
                elif op == "error" and msg.get("id") in self._results:
                    # a submit that errored worker-side (decode failure)
                    fut = self._pop(self._results, msg.get("id"))
                    if fut is not None:
                        fut.set_exception(WorkerProtocolError(
                            f"worker {self.label}: {msg.get('error')}"))
        self._fail_outstanding(f"worker {self.label} closed its pipe")

    def _pop(self, table: Dict[int, Future], req_id) -> Optional[Future]:
        with self._state_lock:
            return table.pop(req_id, None)

    def _fail_outstanding(self, why: str) -> None:
        with self._state_lock:
            pending = list(self._results.values()) + list(self._rpcs.values())
            self._results.clear()
            self._rpcs.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(WorkerProtocolError(why))

    def _alloc(self, table: Dict[int, Future]):
        # returns the Future too: re-reading the table after releasing the
        # lock would race _fail_outstanding (worker death clears both
        # tables -> bare KeyError instead of WorkerProtocolError)
        with self._state_lock:
            self._next_id += 1
            fut = Future()
            table[self._next_id] = fut
            return self._next_id, fut

    # -- API -----------------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def wait_ready(self, timeout: float) -> bool:
        """Wait for the worker's ``ready`` line; False on timeout or as
        soon as the process has died (a worker that raised at startup,
        e.g. without a card, is not waited on for the whole timeout)."""
        deadline = time.monotonic() + timeout
        while not self.ready.wait(0.1):
            if not self.alive or time.monotonic() >= deadline:
                return self.ready.is_set()
        return True

    @property
    def pid(self) -> int:
        """The worker's OS pid: the aggregator's incarnation key (a
        respawned label is a new pid, which is how the seq/rid
        watermarks know to reset)."""
        return self._proc.pid

    def submit(self, kind: str, pubkeys, messages, signature,
               birth_s: Optional[float] = None,
               flow_id: Optional[int] = None) -> "Future[bool]":
        """``birth_s``/``flow_id`` ride the wire: the worker passes them to
        its service's submit, so the ingress latency and the Chrome flow
        id survive the process boundary (the worker-side flow START and a
        router-side FINISH carry the same id and stitch into one
        arrow)."""
        req_id, fut = self._alloc(self._results)
        if kind == "fast_aggregate":
            wire_messages = bytes(messages).hex()
        else:
            wire_messages = [bytes(m).hex() for m in messages]
        msg = {"op": "submit", "id": req_id, "kind": kind,
               "pubkeys": [bytes(pk).hex() for pk in pubkeys],
               "messages": wire_messages,
               "signature": bytes(signature).hex()}
        if birth_s is not None:
            msg["birth"] = float(birth_s)
        if flow_id is not None:
            msg["flow"] = int(flow_id)
        self._send(msg)
        return fut

    def rpc(self, obj: Dict, timeout: Optional[float] = 60.0) -> Dict:
        req_id, fut = self._alloc(self._rpcs)
        self._send(dict(obj, id=req_id))
        return fut.result(timeout=timeout)

    def snapshot(self, timeout: Optional[float] = 60.0,
                 flight_since: int = 0, spans_since: int = 0) -> Dict:
        """``flight_since`` asks the worker to ship only flight events
        past that sequence number (the aggregator dedups by seq anyway —
        this keeps the steady-state control tick from re-piping the full
        4096-event ring every second); ``spans_since`` is the same delta
        cursor for completed trace spans (rid-keyed)."""
        return self.rpc({"op": "snapshot",
                         "flight_since": int(flight_since),
                         "spans_since": int(spans_since)},
                        timeout=timeout)["data"]

    def set_rung(self, rung: int, reason: str = "fleet_shed",
                 timeout: Optional[float] = 60.0) -> None:
        self.rpc({"op": "ladder", "rung": rung, "reason": reason},
                 timeout=timeout)

    def inject_fault(self, calls: int, mode: str = "fail",
                     ms: float = 0.0) -> None:
        self.rpc({"op": "fault", "calls": calls, "mode": mode, "ms": ms})

    def warm(self, k: int, sizes, timeout: Optional[float] = 600.0) -> None:
        self.rpc({"op": "warm", "k": k, "sizes": list(sizes)},
                 timeout=timeout)

    def close(self, timeout: float = 60.0) -> None:
        """Drain and reap: ask for a clean drain, close stdin (the
        worker keeps answering requests already on the pipe until EOF —
        a submit that raced the drain op is served, not black-holed),
        wait for its bye, then escalate."""
        drained = False
        if self.alive:
            try:
                self.rpc({"op": "drain"}, timeout=timeout)
                drained = True
            except Exception:
                pass
        try:
            self._proc.stdin.close()
        except Exception:
            pass
        if drained:
            self.said_bye.wait(timeout)
        try:
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10)
        self._reader.join(timeout=10)


class FleetRouter:
    """The serve fleet's control plane (module docstring has the story).

    ``submit`` mirrors ``VerificationService.submit`` (same argument
    shape, same ``Future[bool]`` answer), so anything that fronts a
    service can front a fleet instead."""

    def __init__(self, workers: int = 2, *, backend: str = "bls",
                 device=None,
                 env: Optional[Dict[str, str]] = None,
                 labels: Optional[List[str]] = None,
                 objectives: Optional[List[Dict]] = None,
                 policy: Optional[ShedPolicy] = None,
                 holddown_s: Optional[float] = None,
                 points_per_worker: int = 64,
                 spawn_timeout: float = 180.0):
        from .worker import CPU_ENV, DEVICE_ENV

        assert workers >= 1 or labels
        # the port's device rule: None is the card (raises without one)
        self.device = resolve_device(device)
        self._labels = list(labels) if labels else [
            f"w{i}" for i in range(workers)]
        self._recorder = flight.maybe_recorder()
        self.aggregator = FleetAggregator()
        self._objectives = objectives
        self._fleet_tracker = SloTracker(objectives)
        self._worker_trackers: Dict[str, SloTracker] = {}
        self._policy = policy if policy is not None else ShedPolicy()
        if holddown_s is None:
            holddown_s = float(os.environ.get(HOLDDOWN_ENV,
                                              str(DEFAULT_HOLDDOWN_S)))
        self._holddown_s = holddown_s
        self._last_action: Dict[str, float] = {}
        self._rungs: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.requests = 0
        self.sheds = 0
        self.drains = 0
        self._closed = False
        self._control_thread: Optional[threading.Thread] = None
        self._control_stop = threading.Event()

        self._handles: Dict[str, WorkerHandle] = {}
        self._ring = HashRing(points_per_worker)
        pin = os.environ.get(PIN_ENV, "1") != "0"
        slices = (_core_slices(len(self._labels)) if pin
                  else [None] * len(self._labels))
        # per-label spawn recipe, kept for respawn(): a crashed worker
        # comes back with the same backend/env/core slice it launched with
        self._backend = backend
        if backend == "bls" and self.device.type == "cuda":
            # one nvcc run for the fleet: the workers load the libraries
            from ..ops import cuda_build

            cuda_build.build()
        self._spawn_env: Dict[str, Dict[str, str]] = {}
        for label, cores in zip(self._labels, slices):
            worker_env = dict(env or {})
            worker_env[DEVICE_ENV] = str(self.device)
            if cores is not None:
                worker_env.setdefault(CPU_ENV, cores)
            self._spawn_env[label] = worker_env
            handle = WorkerHandle(label, env=worker_env, backend=backend)
            self._handles[label] = handle
            if self._recorder is not None:
                self._recorder.note("fleet", "worker_spawned", worker=label,
                                    worker_pid=handle._proc.pid)
        deadline = time.monotonic() + spawn_timeout
        for label, handle in self._handles.items():
            if not handle.wait_ready(max(0.1, deadline - time.monotonic())):
                code = handle._proc.poll()
                self.close(timeout=10)
                raise WorkerProtocolError(
                    f"worker {label} exited with code {code} before it was "
                    "ready" if code is not None else
                    f"worker {label} not ready within {spawn_timeout:.0f}s")
            self._ring.add(label)
            self._rungs[label] = 0
        self._export_gauges()

    # -- routing --------------------------------------------------------------

    @property
    def live_workers(self) -> List[str]:
        with self._lock:
            return [label for label in self._labels
                    if label in self._rungs
                    and self._handles[label].alive]

    def route_label(self, key: bytes) -> str:
        return self._ring.route(key)

    def handle(self, label: str) -> WorkerHandle:
        return self._handles[label]

    def submit(self, kind: str, pubkeys, messages, signature,
               birth_s: Optional[float] = None,
               flow_id: Optional[int] = None) -> "Future[bool]":
        if self._closed:
            raise WorkerProtocolError("submit() on a closed FleetRouter")
        key = check_key(kind, [bytes(pk) for pk in pubkeys],
                        messages if isinstance(messages, (bytes, bytearray))
                        else [bytes(m) for m in messages],
                        bytes(signature))
        label = self._ring.route(key)
        with self._lock:
            self.requests += 1
        return self._handles[label].submit(kind, pubkeys, messages,
                                           signature, birth_s=birth_s,
                                           flow_id=flow_id)

    # -- control plane --------------------------------------------------------

    def poll_snapshots(self, timeout: float = 60.0) -> Dict[str, Dict]:
        """Pull one wire snapshot from every live worker into the
        aggregator; a worker that fails to answer is skipped (its last
        snapshot stays current) and the miss is journaled."""
        out = {}
        for label in self.live_workers:
            try:
                handle = self._handles[label]
                # the handle's live pid guards the delta cursors across a
                # respawn: a fresh incarnation's counters restart, so the
                # aggregator answers 0 until it has ingested that pid
                snap = handle.snapshot(
                    timeout=timeout,
                    flight_since=self.aggregator.last_seq(
                        label, pid=handle.pid),
                    spans_since=self.aggregator.last_rid(
                        label, pid=handle.pid))
                self.aggregator.ingest(label, snap)
                out[label] = snap
            except Exception as e:
                if self._recorder is not None:
                    self._recorder.note(
                        "fleet", "snapshot_miss", worker=label,
                        error=f"{type(e).__name__}: {e}"[:200])
        profiling.set_gauge("fleet.snapshots", self.aggregator.ingests)
        return out

    def _reap_dead(self) -> List[str]:
        """Evict CRASHED workers from the ring (a drain is voluntary and
        removes itself; a kill -9 removes nothing on its own): a dead
        handle would otherwise black-hole its whole key arc forever —
        route() keeps picking it, every submit raises, and no burn can
        accumulate to shed it because errored submits record no latency
        mass. Journaled as ``worker_lost`` with provenance."""
        lost = []
        for label in list(self._rungs):
            if not self._handles[label].alive:
                self._ring.remove(label)
                self._rungs.pop(label, None)
                lost.append(label)
                if self._recorder is not None:
                    self._recorder.note(
                        "fleet", "worker_lost", worker=label,
                        returncode=self._handles[label]._proc.returncode)
        return lost

    def control_tick(self) -> Dict:
        """One loop of measurement -> decision -> actuation: reap crashed
        workers, poll + merge snapshots, evaluate fleet + per-worker burn
        rates, run the shed policy, apply (and journal) its decision."""
        self._reap_dead()
        self.poll_snapshots()
        fleet_eval = self._fleet_tracker.evaluate(hists=self._slo_hists())
        worker_evals = {}
        for label in self.live_workers:
            tracker = self._worker_trackers.get(label)
            if tracker is None:
                tracker = self._worker_trackers[label] = SloTracker(
                    self._objectives)
            worker_evals[label] = tracker.evaluate(
                hists=self.aggregator.worker_hists(label), export=False)
        now = time.monotonic()
        applied = []
        for decision in self._policy.decide(fleet_eval, worker_evals,
                                            dict(self._rungs)):
            last = self._last_action.get(decision.worker)
            if last is not None and now - last < self._holddown_s:
                continue  # hold-down: re-measure before acting again
            self._last_action[decision.worker] = now
            applied.append(self._apply(decision))
        self._export_gauges()
        return {"slo": fleet_eval, "workers": sorted(worker_evals),
                "decisions": applied}

    def _apply(self, decision) -> Dict:
        info = decision.as_dict()
        if decision.action == "shed":
            rung_from = self._rungs.get(decision.worker, 0)
            rung_to = min(2, rung_from + 1)
            info.update(rung_from=rung_from, rung_to=rung_to)
            try:
                self._handles[decision.worker].set_rung(
                    rung_to, reason=f"slo_burn_{decision.objective}")
                self._rungs[decision.worker] = rung_to
            except Exception as e:
                info["error"] = f"{type(e).__name__}: {e}"[:200]
            with self._lock:
                self.sheds += 1
            if self._recorder is not None:
                self._recorder.note("fleet", "shed", **info)
        else:
            with self._lock:
                self.drains += 1
            if self._recorder is not None:
                self._recorder.note("fleet", "drain", **info)
            self.drain(decision.worker)
        return info

    def drain(self, label: str, timeout: float = 60.0) -> None:
        """Remove ``label`` from the ring (its keys re-home, everyone
        else's stay put) and drain the process. Its final snapshot — and
        every journal line it ever shipped — stays in the aggregator:
        fleet totals never forget a drained worker's history."""
        self._ring.remove(label)
        self._rungs.pop(label, None)
        try:
            handle = self._handles[label]
            self.aggregator.ingest(label, handle.snapshot(
                timeout=30,
                flight_since=self.aggregator.last_seq(
                    label, pid=handle.pid),
                spans_since=self.aggregator.last_rid(
                    label, pid=handle.pid)))
        except Exception:
            pass  # the last periodic snapshot stands
        self._handles[label].close(timeout=timeout)
        if self._recorder is not None:
            self._recorder.note("fleet", "worker_drained", worker=label)
        self._export_gauges()

    def respawn(self, label: str, spawn_timeout: float = 180.0
                ) -> WorkerHandle:
        """Bring a crashed (or reaped) worker label back: spawn a fresh
        process with the label's original backend/env/core recipe and
        re-home its hash arc. The NEW pid is what tells the aggregator's
        seq/rid watermarks to reset: the respawned journal and span
        streams merge from their restarted counters instead of being
        silently dropped below the dead incarnation's high water."""
        old = self._handles.get(label)
        if old is not None and old.alive:
            raise WorkerProtocolError(
                f"respawn({label!r}): worker is still alive — drain it "
                f"or let _reap_dead evict it first")
        handle = WorkerHandle(label, env=self._spawn_env.get(label, {}),
                              backend=self._backend)
        if not handle.wait_ready(spawn_timeout):
            handle.close(timeout=10)
            raise WorkerProtocolError(
                f"respawned worker {label} not ready within "
                f"{spawn_timeout:.0f}s")
        self._handles[label] = handle
        self._ring.remove(label)  # no-op when already reaped
        self._ring.add(label)
        self._rungs[label] = 0
        if self._recorder is not None:
            self._recorder.note("fleet", "worker_respawned", worker=label,
                                worker_pid=handle.pid)
        self._export_gauges()
        return handle

    def start_control(self, interval_s: float = 1.0) -> None:
        """Background control loop (bench/production mode; tests and the
        smoke call ``control_tick`` explicitly for determinism)."""
        if self._control_thread is not None:
            return

        def loop():
            while not self._control_stop.wait(interval_s):
                try:
                    self.control_tick()
                except Exception:
                    pass  # a failed tick must never kill the loop

        self._control_thread = threading.Thread(
            target=loop, name="fleet-control", daemon=True)
        self._control_thread.start()

    def _export_gauges(self) -> None:
        profiling.set_gauge("fleet.workers", len(self.live_workers))
        profiling.set_gauge("fleet.requests", self.requests)
        profiling.set_gauge("fleet.sheds", self.sheds)
        profiling.set_gauge("fleet.drains", self.drains)
        profiling.set_gauge("fleet.snapshots", self.aggregator.ingests)

    # -- merged surfaces ------------------------------------------------------

    def scrape_text(self) -> str:
        """The fleet-wide ``/metrics`` body: the merged worker view with
        this process's own state (fleet.* gauges, recomputed slo.*, and
        the router-side latency histograms of whatever consumes the
        fleet's verdicts in this process) overlaid."""
        self._export_gauges()  # fleet.* always current in any scrape
        local_stats, local_gauges = profiling.stats_and_gauges()
        return self.aggregator.render_metrics(
            local_stats=local_stats, local_gauges=local_gauges,
            local_hists=profiling.latency_histograms())

    def _slo_hists(self) -> Dict:
        """Worker-merged histograms overlaid with this process's own: a
        latency recorded in the ROUTER process by whatever consumes the
        fleet's verdicts (``latency.gossip_to_head``) must reach the SLO
        machinery (burn rates, shedding, /healthz), not just /metrics."""
        merged = self.aggregator.merged_hists()
        for label, h in profiling.latency_histograms().items():
            prev = merged.get(label)
            merged[label] = h if prev is None else prev.merge(h)
        return merged

    def healthz(self) -> Dict:
        """Fleet liveness + objective state over the MERGED histograms."""
        evaluated = self._fleet_tracker.evaluate(hists=self._slo_hists())
        return {
            "ok": all(e["ok"] for e in evaluated.values()),
            "workers": self.live_workers,
            "rungs": dict(self._rungs),
            "slo": evaluated,
        }

    def journal_jsonl(self, reason: str = "fleet_dump") -> str:
        return self.aggregator.journal_jsonl(local_recorder=self._recorder,
                                             reason=reason)

    def timeseries_doc(self) -> Dict:
        """The fleet-wide ``/timeseries`` body: every worker's TSDB wire
        merged exactly with the router's own store (when armed), then
        rendered (percentiles computed on the MERGED histogram deltas —
        fleet p99s, not averaged worker p99s)."""
        from ..obs import timeseries

        store = timeseries.maybe_store()
        merged = self.aggregator.merged_timeseries_wire(
            local_wire=store.to_wire() if store is not None else None)
        return timeseries.render_wire(merged)

    def dump_trace(self, path: str) -> str:
        """ONE stitched Chrome trace: the router's own lanes (pipeline /
        vm / devices / flight journal) plus every worker's request spans
        on per-worker pids, flow ids joined across the process boundary
        (load it in Perfetto)."""
        from ..obs import tracing

        return tracing.dump_stitched_trace(
            path, self.aggregator.worker_span_sections())

    def start_exposition(self, port: int = 0):
        """The fleet's merged exposition endpoint: ``/metrics`` renders
        the aggregator's cross-process merge, ``/healthz`` the fleet SLO
        state, ``/flightdump`` the merged journal, ``/timeseries`` the
        merged time-series rings."""
        from ..obs.exposition import start_exposition

        return start_exposition(
            port=port,
            metrics_fn=self.scrape_text,
            healthz_fn=self.healthz,
            flight_fn=lambda: self.journal_jsonl(
                reason="flightdump_endpoint"),
            snapshot_fn=lambda: {
                "workers": {label: self.aggregator.worker_snapshot(label)
                            for label in self.aggregator.workers},
                "fleet": {"requests": self.requests, "sheds": self.sheds,
                          "drains": self.drains,
                          "live": self.live_workers},
            },
            timeseries_fn=self.timeseries_doc)

    # -- lifecycle ------------------------------------------------------------

    def close(self, timeout: float = 60.0) -> None:
        self._closed = True
        self._control_stop.set()
        if self._control_thread is not None:
            self._control_thread.join(timeout=10)
        for handle in self._handles.values():
            handle.close(timeout=timeout)
        self._export_gauges()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
