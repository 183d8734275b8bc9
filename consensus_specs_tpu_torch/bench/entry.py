"""The port's bench entry: ``python -m consensus_specs_tpu_torch.bench``.

    python -m consensus_specs_tpu_torch.bench [--mode M] [--device cpu]
        [--trace out.json] [--flight out.jsonl]

Each mode prints ONE JSON line with the JAX package's ``bench.py`` keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``mode`` and the mode's
own sections under the JAX names) plus ``platform`` ("gpu" or "cpu"),
``device`` (the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit`` gives them; null on the CPU) and
``launches``: the step kernel's (``vm_step``, ``vm_step_steps``) and the
Montgomery kernel's (``mont_mul``, ``mont_mul_captures``) counters over
the mode's run in this process, counted from 0 when it starts (fleet
workers report their own counts in their rows). Nothing else goes to
stdout: a mode's own prints land on stderr.

Modes: ``committee`` (N aggregates of K signers through
``batch_fast_aggregate_verify``: BENCH_N 32, BENCH_K 128, BENCH_REPS 2 on
the card and 3 on the CPU; the value is the median rep, the warm-up that
assembles the bucket's programs is reported as ``warmup_s``), ``epoch``
(BASELINE config 4, ``bench/epoch_replay.py``), ``head``, ``codec``,
``rlc``, ``mainnet``, ``latency``, ``soak``, ``merkle``, ``proofs``,
``sim``, ``serve`` (with ``--trace`` and ``--flight``), ``serve-fleet``,
``vmexec`` (the interpreter against the fused lowering,
``bench/vmexec.py``, with its cold child ``bench/vmexec_cold.py``) and
``finalexp`` (the hard-part variants against the host oracle,
``bench/finalexp.py``); each mode's knobs are its module's env vars. With no
``--mode`` it runs committee at 32 x 128 and then the epoch at the mainnet
shape in one process, a line each (BENCH_MODE picks one of the two;
it names no other mode).

Without ``--device cpu`` it runs on the CUDA card, and without a card it
prints an ``error`` line and exits 1. A mode that raises prints an
``error`` line and exits 1, and so does ``finalexp`` when a cell is not
``ok``. ``serve-mesh`` and ``--mesh`` exit 2 with an ``error`` line naming
the ROADMAP item they wait for.
"""
import contextlib
import json
import os
import sys
import time
import traceback

TARGET_PER_CHIP = 150_000 / 8  # north star: 300k signatures < 2 s on 8 chips

# the run with no --mode, in order: bench.py's accelerator child
DEFAULT_STAGES = ("committee", "epoch")

UNPORTED = {
    "serve-mesh": "ROADMAP Queue 1 item 8 (multi-device)",
    "--mesh": "ROADMAP Queue 1 item 8 (multi-device)",
}


def _opt(argv, name):
    """``<name> <v>`` / ``<name>=<v>`` from argv."""
    for i, arg in enumerate(argv):
        if arg == name and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith(name + "="):
            return arg.split("=", 1)[1]
    return None


def _line(value, vs_baseline, **extra) -> dict:
    line = {
        "metric": "aggregate BLS signatures verified/sec/chip",
        "value": round(value, 2),
        "unit": "signatures/sec",
        "vs_baseline": round(vs_baseline, 4),
    }
    line.update(extra)
    return line


def _card(dev):
    """The card's name and power limit (nvidia-smi), or None on the CPU."""
    if dev.type != "cuda":
        return None
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in out.split(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        import torch

        name, power = torch.cuda.get_device_name(dev), None
    return {"name": name, "power_limit": power}


def _counters():
    from ..ops import cuda_fq, cuda_step

    return {"vm_step": cuda_step.LAUNCHES, "vm_step_steps": cuda_step.STEPS,
            "mont_mul": cuda_fq.LAUNCHES,
            "mont_mul_captures": cuda_fq.CAPTURES}


def _reset_counters():
    from ..ops import cuda_fq, cuda_step

    cuda_step.LAUNCHES = cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = cuda_fq.CAPTURES = 0


def run_committee(device) -> dict:
    """N FastAggregateVerify items of K signers each (one message an item,
    the summed-key signature) through ``batch_fast_aggregate_verify``:
    a warm-up call (input prep and program assembly, reported as
    ``warmup_s``) and BENCH_REPS timed calls; the value is the median."""
    from ..obs import programs as obs_programs
    from ..ops import bls_backend, profiling
    from ..utils import bls
    from ..utils.bls12_381 import R

    profiling.reset()
    obs_programs.export_gauges()
    n = int(os.environ.get("BENCH_N", "32"))
    k = int(os.environ.get("BENCH_K", "128"))
    reps = int(os.environ.get("BENCH_REPS",
                              "3" if device.type == "cpu" else "2"))
    if n <= 0 or k <= 0:
        raise ValueError(f"committee shape N={n}, K={k}")

    t0 = time.perf_counter()
    privkeys = [i + 1 for i in range(k)]
    pubkeys = [bls.SkToPk(sk) for sk in privkeys]
    # an aggregate of same-message signatures equals one signature by the
    # summed secret key: setup is n signs, not n*k
    agg_sk = sum(privkeys) % R
    pubkey_sets, messages, signatures = [], [], []
    for i in range(n):
        msg = i.to_bytes(32, "little")
        pubkey_sets.append(pubkeys)
        messages.append(msg)
        signatures.append(bls.Sign(agg_sk, msg))
    setup_s = time.perf_counter() - t0

    def verify():
        return bls_backend.batch_fast_aggregate_verify(
            pubkey_sets, messages, signatures, device=device)

    t0 = time.perf_counter()
    got = verify()
    warm_s = time.perf_counter() - t0
    assert got.all(), "warmup verification failed"
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = verify()
        times.append(time.perf_counter() - t0)
        assert got.all(), "benchmark verification failed"
    times.sort()
    # the median rep: stabler than the best against one lucky rep
    best = times[len(times) // 2] if times else warm_s
    value = n * k / best
    out = dict(value=value, vs_baseline=value / TARGET_PER_CHIP,
               mode="committee", n=n, k=k, reps=reps,
               rep_seconds=[round(t, 4) for t in times],
               warmup_s=round(warm_s, 3), setup_s=round(setup_s, 3),
               verdicts_ok=True)
    if profiling.enabled():
        out["profile"] = profiling.summary()
        out["programs"] = obs_programs.registry_snapshot()["programs"]
    return out


def run_serve(device, argv) -> dict:
    """The serve bench (``serve/load.run_serve_bench``), with ``--trace``
    exporting the span tracer's Chrome trace and ``--flight`` the flight
    recorder's journal after the run."""
    from ..serve.load import run_serve_bench

    trace_path = _opt(argv, "--trace")
    flight_path = _opt(argv, "--flight")
    switches = {}
    if trace_path:
        switches["CONSENSUS_SPECS_TPU_TRACE"] = "1"
    if flight_path:
        switches["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"
    # on for this run only: a later mode in the process (and the fleet
    # workers it spawns) runs without them
    was = {key: os.environ.get(key) for key in switches}
    os.environ.update(switches)
    try:
        result = run_serve_bench(device=device)
    finally:
        for key, value in was.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
    result["serve_device"] = result.pop("device", str(device))
    if trace_path:
        from ..obs import tracing

        result["trace"] = tracing.dump_trace(trace_path)
        result["trace_requests"] = tracing.global_tracer().finished_total()
    if flight_path:
        from ..obs import flight

        rec = flight.global_recorder()
        result["flight"] = rec.dump(flight_path, reason="bench_flight")
        result["flight_events"] = rec.counters()["events"]
    return result


def run_finalexp(device, argv) -> dict:
    """The finalexp bench (``bench/finalexp.py``). A cell that is not
    ``ok`` (an exception or a wrong verdict on valid rows) fails the mode;
    its ``bars`` are reported as computed."""
    from .finalexp import run_finalexp_bench

    result = run_finalexp_bench(device=device)
    bad = {k: c for k, c in result["finalexp"].items() if not c["ok"]}
    if bad:
        raise AssertionError(f"finalexp cells not ok: {bad}")
    return result


def _module_mode(module, fn):
    def run(device, argv):
        import importlib

        mod = importlib.import_module(f"{__package__}.{module}")
        return getattr(mod, fn)(device=device)
    return run


MODES = {
    "committee": lambda device, argv: run_committee(device),
    "epoch": _module_mode("epoch_replay", "run_epoch_replay"),
    "head": _module_mode("head_replay", "run_head_bench"),
    "codec": _module_mode("codec_prep", "run_codec_bench"),
    "rlc": _module_mode("rlc_final", "run_rlc_bench"),
    "mainnet": _module_mode("mainnet", "run_mainnet_bench"),
    "latency": _module_mode("latency_pipeline", "run_latency_bench"),
    "soak": _module_mode("soak", "run_soak_bench"),
    "merkle": _module_mode("merkle", "run_merkle_bench"),
    "proofs": _module_mode("proofs", "run_proofs_bench"),
    "sim": _module_mode("sim_matrix", "run_sim_bench"),
    "serve": run_serve,
    "serve-fleet": _module_mode("fleet_sweep", "run_fleet_bench"),
    "vmexec": _module_mode("vmexec", "run_vmexec_bench"),
    "finalexp": run_finalexp,
}


def run_mode(mode: str, device, argv=()) -> dict:
    """One mode on ``device`` (a resolved ``torch.device``): its line as a
    dict, with the platform, the card and the launch counts added. A
    mode's own stdout goes to stderr."""
    from ..ops import profiling
    from ..utils import bls

    # each mode starts from clean accumulators, as in a process of its own
    # (the fleet's scrape overlays this process's latency histograms)
    profiling.reset()
    _reset_counters()
    switchboard = bls._backend
    if device.type == "cpu":
        bls.use_py_ecc()  # the spec's own checks on the CPU oracle too
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = MODES[mode](device, list(argv))
    finally:
        bls._backend = switchboard
    seconds = time.perf_counter() - t0
    result = dict(result)
    line = _line(result.pop("value"), result.pop("vs_baseline"), **result)
    line.update(mode=line.get("mode", mode),
                platform="gpu" if device.type == "cuda" else "cpu",
                device=_card(device), launches=_counters(),
                seconds=round(seconds, 3))
    return line


def main(argv=None) -> int:
    """Run the modes ``argv`` asks for; 0 when every line is a result, 1
    on an error line, 2 for a mode the port does not have yet."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out = sys.stdout

    def emit(line):
        print(json.dumps(line), file=out, flush=True)

    mode = _opt(argv, "--mode")
    # bench.py's way to run one stage of the no-mode run
    env_mode = None if mode is not None else os.environ.get("BENCH_MODE")
    mode = mode or env_mode or None
    for name in (mode, "--mesh" if _opt(argv, "--mesh") is not None
                 or "--mesh" in argv else None):
        if name in UNPORTED:
            emit(_line(0.0, 0.0, mode=name, error=(
                f"{name} is not ported yet: {UNPORTED[name]}")))
            return 2
    if env_mode and env_mode not in DEFAULT_STAGES:
        emit(_line(0.0, 0.0, mode=env_mode, error=(
            f"BENCH_MODE={env_mode!r} picks one of {list(DEFAULT_STAGES)}; "
            "other modes take --mode")))
        return 2
    if mode is not None and mode not in MODES:
        emit(_line(0.0, 0.0, mode=mode,
                   error=f"unknown mode {mode!r}; modes: {sorted(MODES)}"))
        return 2

    import torch

    want = _opt(argv, "--device")
    if want is None and not torch.cuda.is_available():
        emit(_line(0.0, 0.0, mode=mode or "committee", error=(
            "no CUDA device: the bench runs on the card; pass --device cpu "
            "for the plain PyTorch path")))
        return 1
    device = torch.device(want or "cuda")

    stages = [mode] if mode is not None else DEFAULT_STAGES
    rc = 0
    for stage in stages:
        try:
            emit(run_mode(stage, device, argv))
        except Exception as e:
            tail = traceback.format_exc().strip().splitlines()[-3:]
            emit(_line(0.0, 0.0, mode=stage,
                       error=f"{type(e).__name__}: {e}"[:500],
                       error_tail=tail))
            rc = 1
    return rc
