"""Fleet worker: one ``VerificationService`` process behind the router (the
port's counterpart of consensus_specs_tpu/serve/worker.py, the same
protocol).

``python -m consensus_specs_tpu_torch.serve.worker`` is the process unit
of the serve fleet: the router (``serve/fleet.py``) spawns N of these,
routes checks to them by consistent-hash content key, and drives them
with the control protocol below. The process boundary is the point: each
worker owns its own GIL, its own prep thread, its own CUDA context on the
card, its own result cache and its own observability state, which it
ships home as ``obs/snapshot.py`` wire snapshots for exact merging.

Protocol: newline-delimited JSON over stdin/stdout. Binary fields travel
as hex. Requests carry an ``id`` the reply echoes; ``submit`` replies
arrive in COMPLETION order (the service resolves futures as flushes
finish), everything else answers in line.

  parent -> worker                      worker -> parent
  ----------------                      ----------------
                                        {"op":"ready","label","pid"}
  {"op":"submit","id",kind,...}         {"op":"result","id","ok"}
  {"op":"snapshot","id",flight_since?}  {"op":"snapshot","id","data"}
  {"op":"ladder","id","rung",reason?}   {"op":"ok","id"}
  {"op":"fault","id","calls",mode?,ms?} {"op":"ok","id"}    (test/smoke)
  {"op":"warm","id","k","sizes"}        {"op":"ok","id"}
  {"op":"drain","id"}                   {"op":"ok","id"}; keeps serving
                                        already-piped requests until
                                        stdin EOF, then {"op":"bye"}
  (stdin EOF)                           drain + exit
  anything else                         {"op":"error","id","error"}

Stdout is the protocol, so the worker moves file descriptor 1 aside at
startup: whatever else writes to stdout (a print, a library's log line)
lands on stderr instead of corrupting the stream.

Env (set by the router): ``CONSENSUS_SPECS_TPU_FLEET_WORKER`` is the
worker label (it also suffixes every flight dump, see
``obs/flight.resolve_dump_path``); ``CONSENSUS_SPECS_TPU_FLEET_BACKEND``
picks the backend: ``bls`` (default: the port's backend on the worker's
device) or ``verdict`` (the crypto-free ``serve/load.VerdictBackend``,
which builds no kernel and does no device work);
``CONSENSUS_SPECS_TPU_FLEET_DEVICE`` is the worker's device: unset means
the CUDA card, and the worker raises at startup when there is none
(``device.resolve_device``); ``cpu`` runs the plain PyTorch versions (the
tests); ``CONSENSUS_SPECS_TPU_FLEET_CPU`` is its core slice;
``SERVE_MAX_BATCH`` / ``SERVE_MAX_WAIT_MS`` size the service's flush.

Each snapshot's ``extra`` carries the service's metrics, the commanded
ladder rung, the injected faults fired, the resolved device (and on a
card its name), whether this process initialized CUDA, the steps and
registers of every program it resolved, and its kernel launch counts
(``cuda_step.LAUNCHES`` / ``STEPS``, ``cuda_fq.LAUNCHES`` /
``CAPTURES``; 0 where the kernel modules were never imported), so the
parent can show that the kernels ran in the workers. ``warm_bg`` is
False: background program warming comes with ``ops/vm_compile.py``,
which the port does not have. With ``CONSENSUS_SPECS_TPU_FLEET_REPORT_
MODULES=1`` it also lists every module the worker loaded.

The ``fault`` op arms deterministic backend-fault injection: the next
``calls`` backend calls either raise (``mode="fail"``: the service walks
its retry -> per-group -> oracle ladder) or sleep ``ms`` first
(``mode="slow"``), which is how the fleet smoke and tests light up a
worker's latency histogram to force an SLO burn.
"""
import json
import os
import sys
import threading
import time

WORKER_ENV = "CONSENSUS_SPECS_TPU_FLEET_WORKER"
BACKEND_ENV = "CONSENSUS_SPECS_TPU_FLEET_BACKEND"
CPU_ENV = "CONSENSUS_SPECS_TPU_FLEET_CPU"
DEVICE_ENV = "CONSENSUS_SPECS_TPU_FLEET_DEVICE"
REPORT_MODULES_ENV = "CONSENSUS_SPECS_TPU_FLEET_REPORT_MODULES"

_KERNEL_COUNTS = (
    ("consensus_specs_tpu_torch.ops.cuda_step", "LAUNCHES", "vm_step"),
    ("consensus_specs_tpu_torch.ops.cuda_step", "STEPS", "vm_step_steps"),
    ("consensus_specs_tpu_torch.ops.cuda_fq", "LAUNCHES", "mont_mul"),
    ("consensus_specs_tpu_torch.ops.cuda_fq", "CAPTURES", "mont_mul_captures"),
)


def _apply_affinity():
    """Pin this worker to its core slice (CONSENSUS_SPECS_TPU_FLEET_CPU, a
    comma list of core ids set by the router) and return the slice, or
    None when the process stays unpinned. Without pinning, N workers'
    intra-op thread pools oversubscribe the host N-fold (the JAX package
    measured 0.63x single-process throughput at 2 workers on 2 cores).
    Best-effort: no sched_setaffinity, malformed values or an empty slice
    leave the process unpinned."""
    raw = (os.environ.get(CPU_ENV) or "").strip()
    if not raw or not hasattr(os, "sched_setaffinity"):
        return None
    try:
        cores = {int(tok) for tok in raw.split(",") if tok.strip() != ""}
        if cores:
            os.sched_setaffinity(0, cores)
            return cores
    except (ValueError, OSError):
        pass
    return None


def worker_device():
    """The worker's device from CONSENSUS_SPECS_TPU_FLEET_DEVICE: unset is
    the CUDA card (raises without one), anything else is passed to
    ``torch.device``."""
    from ..device import resolve_device

    raw = (os.environ.get(DEVICE_ENV) or "").strip()
    return resolve_device(raw or None)


class _FaultableBackend:
    """Delegating backend proxy with armable fault injection.

    ``arm(calls, mode, ms)``: the next ``calls`` verification calls
    either raise (``fail``) or sleep ``ms`` milliseconds first
    (``slow``). ``prewarm_host_caches`` and every other attribute pass
    straight through; ``batch_verify_rlc`` is only visible when the
    inner backend has it (so verdict-mode services keep their per-group
    routing)."""

    _GATED = ("batch_fast_aggregate_verify", "batch_aggregate_verify",
              "batch_verify_rlc")

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()
        self._remaining = 0
        self._mode = "fail"
        self._ms = 0.0
        self.fired = 0

    def arm(self, calls: int, mode: str = "fail", ms: float = 0.0) -> None:
        with self._lock:
            self._remaining = max(0, int(calls))
            self._mode = mode
            self._ms = float(ms)

    def _gate(self) -> None:
        with self._lock:
            if self._remaining <= 0:
                return
            self._remaining -= 1
            self.fired += 1
            mode, ms = self._mode, self._ms
        if mode == "slow":
            time.sleep(ms / 1e3)
            return
        raise RuntimeError("injected worker fault (fleet fault op)")

    def __getattr__(self, name):
        inner_attr = getattr(self._inner, name)  # AttributeError propagates
        if name not in self._GATED:
            return inner_attr

        def gated(*args, **kwargs):
            self._gate()
            return inner_attr(*args, **kwargs)

        return gated


class _VerdictOracle:
    """Per-item fallback matching ``VerdictBackend``'s rule (verdict mode
    never reaches the pure-Python pairing oracle)."""

    def verify_one(self, p) -> bool:
        from .load import BAD_SIGNATURE

        return bytes(p.signature) != BAD_SIGNATURE


def _build_service(device):
    """(service, faultable backend) for the configured backend mode."""
    from .service import VerificationService

    backend_kind = os.environ.get(BACKEND_ENV, "bls").strip() or "bls"
    max_batch = int(os.environ.get("SERVE_MAX_BATCH", "32"))
    max_wait_ms = float(os.environ.get("SERVE_MAX_WAIT_MS", "20"))
    if backend_kind == "verdict":
        from .load import VerdictBackend
        from .metrics import _pow2

        backend = _FaultableBackend(VerdictBackend())
        svc = VerificationService(
            backend=backend, oracle=_VerdictOracle(), device=device,
            bucket_fn=_pow2, max_batch=max_batch, max_wait_ms=max_wait_ms)
        return svc, backend
    from ..ops import bls_backend

    backend = _FaultableBackend(bls_backend)
    svc = VerificationService(backend=backend, device=device,
                              max_batch=max_batch, max_wait_ms=max_wait_ms)
    return svc, backend


def _warm_committees(k: int, n: int, seed: int = 9901):
    """Synthetic warm-up committees (content disjoint from any stream:
    the seed namespace is the worker's own)."""
    from ..utils import bls
    from ..utils.bls12_381 import R

    items = []
    for ci in range(n):
        sks = [seed * 10_000 + ci * 100 + j + 1 for j in range(k)]
        pks = [bls.SkToPk(sk) for sk in sks]
        msg = (b"warm%04d" % ci) + b"\x00" * 24
        items.append(("fast_aggregate", pks, msg, bls.Sign(sum(sks) % R, msg)))
    return items


def _warm(k: int, sizes, device) -> None:
    """Pay program assembly for the given flush sizes outside any timed
    window (the serve bench's warm-up, worker-side), on the worker's
    device."""
    from ..ops import bls_backend

    sizes = sorted({int(s) for s in sizes if int(s) > 0}, reverse=True)
    if not sizes:
        return
    items = _warm_committees(k, sizes[0])
    for size in sizes:
        bls_backend.batch_verify_rlc(items[:size], device=device)


def _decode_submit(msg):
    kind = msg["kind"]
    pubkeys = [bytes.fromhex(pk) for pk in msg["pubkeys"]]
    if kind == "fast_aggregate":
        messages = bytes.fromhex(msg["messages"])
    else:
        messages = [bytes.fromhex(m) for m in msg["messages"]]
    signature = bytes.fromhex(msg["signature"])
    return kind, pubkeys, messages, signature


def _kernel_counts():
    """The kernel wrappers' launch counters, read without importing their
    modules (a verdict worker never loads the CUDA build)."""
    out = {}
    for module, attr, key in _KERNEL_COUNTS:
        mod = sys.modules.get(module)
        out[key] = int(getattr(mod, attr, 0)) if mod is not None else 0
    return out


def _device_extra(device):
    import torch

    from ..obs import programs

    extra = {"device": device.type,
             "cuda_initialized": bool(torch.cuda.is_initialized()),
             "kernels": _kernel_counts(), "warm_bg": False,
             # each resolved program's shape, keyed kind[k=...,fold=...]:
             # with the vm[steps=...,regs=...,batch=...] stats it names
             # every (program, rows) the step kernel ran at
             "programs": {key: {"steps": p["steps"], "regs": p["regs"]}
                          for key, p in
                          programs.registry_snapshot()["programs"].items()}}
    if device.type == "cuda":
        extra["device_name"] = torch.cuda.get_device_name(device)
    if os.environ.get(REPORT_MODULES_ENV) == "1":
        extra["modules"] = sorted(sys.modules)
    return extra


def _protocol_stream():
    """Move file descriptor 1 aside for the protocol and point fd 1 (and
    ``sys.stdout``) at stderr, so nothing but protocol lines reaches the
    parent's pipe."""
    proto = os.fdopen(os.dup(1), "w", buffering=1, encoding="utf-8")
    sys.stdout.flush()
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return proto


def main() -> int:
    proto = _protocol_stream()
    cores = _apply_affinity()
    import torch

    if cores:
        # one intra-op thread per core of the slice: N workers' pools
        # would otherwise oversubscribe the host N-fold
        torch.set_num_threads(len(cores))
    label = os.environ.get(WORKER_ENV, f"w{os.getpid()}")
    device = worker_device()  # raises here when there is no card
    from ..obs import snapshot, timeseries
    from ..utils import bls

    # verdicts must flow through the service, not the stub's eager True
    bls.bls_active = True
    svc, backend = _build_service(device)

    # telemetry plane: when the TSDB env is set (inherited from the
    # router), sample this worker's gauges and histograms on the
    # configured interval; the rings ship home in every snapshot and
    # merge exactly in the aggregator
    sampler = (timeseries.start_sampler() if timeseries.ts_enabled()
               else None)

    out_lock = threading.Lock()

    def send(obj) -> None:
        line = json.dumps(obj, separators=(",", ":"))
        with out_lock:
            proto.write(line + "\n")
            proto.flush()

    def on_done(req_id):
        def cb(fut):
            try:
                send({"op": "result", "id": req_id, "ok": bool(fut.result())})
            except Exception as e:  # a lost future must still answer
                send({"op": "error", "id": req_id,
                      "error": f"{type(e).__name__}: {e}"[:200]})
        return cb

    send({"op": "ready", "label": label, "pid": os.getpid()})
    try:
        for raw in sys.stdin:
            raw = raw.strip()
            if not raw:
                continue
            msg = None
            try:
                msg = json.loads(raw)
                op = msg.get("op")
                req_id = msg.get("id")
                if op == "submit":
                    kind, pubkeys, messages, signature = _decode_submit(msg)
                    birth = msg.get("birth")
                    flow = msg.get("flow")
                    fut = svc.submit(
                        kind, pubkeys, messages, signature,
                        birth_s=None if birth is None else float(birth),
                        flow_id=None if flow is None else int(flow))
                    fut.add_done_callback(on_done(req_id))
                elif op == "snapshot":
                    data = snapshot.take_process_snapshot(
                        worker=label,
                        extra={"serve": svc.metrics.snapshot(),
                               "ladder_rung": svc.ladder_rung,
                               "faults_fired": backend.fired,
                               **_device_extra(device)},
                        flight_since=int(msg.get("flight_since", 0)),
                        spans_since=int(msg.get("spans_since", 0)))
                    send({"op": "snapshot", "id": req_id, "data": data})
                elif op == "ladder":
                    svc.set_ladder_rung(int(msg["rung"]),
                                        reason=msg.get("reason", "fleet"))
                    send({"op": "ok", "id": req_id})
                elif op == "fault":
                    backend.arm(int(msg.get("calls", 1)),
                                mode=msg.get("mode", "fail"),
                                ms=float(msg.get("ms", 0.0)))
                    send({"op": "ok", "id": req_id})
                elif op == "warm":
                    _warm(int(msg.get("k", 8)), msg.get("sizes", (1,)),
                          device)
                    send({"op": "ok", "id": req_id})
                elif op == "drain":
                    # acknowledge but KEEP READING until stdin EOF: a
                    # submit the router routed before removing this
                    # worker from the ring can already be on the pipe
                    # behind the drain op; it must be answered (the
                    # parent closes stdin right after the ack, which ends
                    # the loop)
                    send({"op": "ok", "id": req_id})
                else:
                    send({"op": "error", "id": req_id,
                          "error": f"unknown op {op!r}"})
            except Exception as e:
                send({"op": "error", "id": msg.get("id")
                      if isinstance(msg, dict) else None,
                      "error": f"{type(e).__name__}: {e}"[:200]})
    finally:
        if sampler is not None:
            sampler.close()
        svc.close(timeout=60)
        try:
            send({"op": "bye"})
        except (BrokenPipeError, OSError, ValueError):
            pass  # parent already gone: the drain still completed
    return 0


if __name__ == "__main__":
    sys.exit(main())
