"""The port's bench entry (``python -m consensus_specs_tpu_torch.bench``,
``bench/entry.main``) on the CPU: each mode not held against the JAX
package in tests/test_torch_bench.py prints one parseable line with
``bench.py``'s keys at tiny knobs; the modes the port does not have yet
exit 2 naming their ROADMAP item; without a card and without ``--device
cpu`` it exits 1 with an error line; with no ``--mode`` it runs committee
then the epoch; and ``python -m`` runs it as a module."""
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("metric", "value", "unit", "vs_baseline", "mode", "platform",
        "device", "launches", "seconds")


def _run(argv, monkeypatch, knobs=()):
    from consensus_specs_tpu_torch.bench import entry

    for k, v in dict(knobs).items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry.main(list(argv))
    return rc, [json.loads(x) for x in buf.getvalue().strip().splitlines()]


@pytest.mark.parametrize("mode,knobs,fields", [
    ("committee", {"BENCH_N": "2", "BENCH_K": "2", "BENCH_REPS": "0",
                   "CONSENSUS_SPECS_TPU_PROFILE": "1"},
     {"n": 2, "k": 2, "reps": 0, "verdicts_ok": True}),
    ("proofs", {"CONSENSUS_SPECS_TPU_PROOF_CLIENTS": "100",
                "CONSENSUS_SPECS_TPU_PROOF_SLOTS": "1",
                "CONSENSUS_SPECS_TPU_PROOF_VALIDATORS": "16",
                "CONSENSUS_SPECS_TPU_PROOF_BACKEND": "verdict"},
     {"verified": True, "hit_rate": round(100 / 101, 6),
      "checked_requests": 100}),
    ("sim", {"CONSENSUS_SPECS_TPU_SIM_SCENARIOS": "partition_heal"},
     {"scenarios": 1, "converged": 1, "diverged": []}),
    ("serve", {"SERVE_EVENTS": "8", "SERVE_COMMITTEES": "2",
               "SERVE_K": "2"},
     {"lost": 0, "wrong": 0, "fallback_items": 0}),
    ("serve-fleet", {"SERVE_FLEET_WORKERS": "1",
                     "SERVE_FLEET_COMMITTEES": "1", "SERVE_FLEET_K": "1",
                     "SERVE_FLEET_ROUNDS": "1"},
     {"worker_counts": [1], "committees": 1, "k": 1}),
])
def test_mode_prints_one_line_with_the_bench_keys(mode, knobs, fields,
                                                  monkeypatch, tmp_path):
    argv = ["--mode", mode, "--device", "cpu"]
    if mode == "serve":
        monkeypatch.delenv("CONSENSUS_SPECS_TPU_TRACE", raising=False)
        monkeypatch.delenv("CONSENSUS_SPECS_TPU_FLIGHT", raising=False)
        argv += ["--trace", str(tmp_path / "t.json"),
                 "--flight", str(tmp_path / "f.jsonl")]
    rc, lines = _run(argv, monkeypatch, knobs)
    assert rc == 0 and len(lines) == 1, lines
    line = lines[0]
    assert "error" not in line, line
    for key in KEYS:
        assert key in line, key
    assert line["mode"] == mode and line["platform"] == "cpu"
    assert line["device"] is None
    assert line["launches"]["vm_step"] == line["launches"]["mont_mul"] == 0
    for k, v in fields.items():
        assert line[k] == v, (k, line[k])
    if mode == "committee":  # CONSENSUS_SPECS_TPU_PROFILE=1
        assert line["profile"] and line["programs"]
    if mode == "serve":  # --trace and --flight wrote their files
        assert line["trace"] == str(tmp_path / "t.json")
        assert line["trace_requests"] >= 1
        assert json.load(open(line["trace"]))["traceEvents"]
        assert line["flight_events"] > 0
        assert os.path.exists(tmp_path / "f.jsonl")
        # on for the serve run only: later modes run without them
        assert "CONSENSUS_SPECS_TPU_TRACE" not in os.environ
        assert "CONSENSUS_SPECS_TPU_FLIGHT" not in os.environ
    if mode == "serve-fleet":
        row = line["fleet"]["1"]
        assert row["ok"] is True, row
        assert row["merge_exact"]["ok"] is True
        assert set(row["worker_kernels"]) == {"w0"}


@pytest.mark.parametrize("argv,item", [
    (["--mode", "vmexec"], "item 6"),
    (["--mode", "finalexp"], "item 7"),
    (["--mode", "serve-mesh"], "item 8"),
    (["--mode", "serve", "--mesh", "4"], "item 8"),
])
def test_unported_modes_exit_2_naming_their_roadmap_item(argv, item,
                                                         monkeypatch):
    rc, lines = _run(argv + ["--device", "cpu"], monkeypatch)
    assert rc == 2 and len(lines) == 1
    assert "ROADMAP Queue 1 " + item in lines[0]["error"]
    assert lines[0]["value"] == 0.0


@pytest.mark.parametrize("bench_mode,said", [
    ("vmexec", "ROADMAP Queue 1 item 6"),
    ("head", "picks one of ['committee', 'epoch']"),
    ("nosuch", "picks one of ['committee', 'epoch']"),
])
def test_bench_mode_names_a_stage_of_the_no_mode_run(bench_mode, said,
                                                     monkeypatch):
    rc, lines = _run(["--device", "cpu"], monkeypatch,
                     {"BENCH_MODE": bench_mode})
    assert rc == 2 and len(lines) == 1
    assert lines[0]["mode"] == bench_mode and said in lines[0]["error"]


def test_without_a_card_it_exits_1_with_an_error_line(monkeypatch):
    from consensus_specs_tpu_torch.bench import entry

    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(entry.MODES, "head",
                        lambda device, argv: ran.append(device))
    for argv in (["--mode", "head"], []):
        rc, lines = _run(argv, monkeypatch)
        assert rc == 1 and len(lines) == 1
        assert "no CUDA device" in lines[0]["error"]
    assert ran == []


def test_a_failing_mode_is_an_error_line_and_exit_1(monkeypatch):
    from consensus_specs_tpu_torch.bench import entry

    def boom(device, argv):
        raise AssertionError("epoch verification failed")
    monkeypatch.setitem(entry.MODES, "epoch", boom)
    rc, lines = _run(["--mode", "epoch", "--device", "cpu"], monkeypatch)
    assert rc == 1 and len(lines) == 1
    assert lines[0]["error"] == \
        "AssertionError: epoch verification failed"


def test_no_mode_runs_committee_then_epoch_in_one_process(monkeypatch):
    from consensus_specs_tpu_torch.bench import entry

    order = []

    def stage(name):
        def run(device, argv):
            order.append((name, device.type))
            return {"value": 1.0, "vs_baseline": 0.5, "mode": name}
        return run
    monkeypatch.delenv("BENCH_MODE", raising=False)
    monkeypatch.setitem(entry.MODES, "committee", stage("committee"))
    monkeypatch.setitem(entry.MODES, "epoch", stage("epoch"))
    rc, lines = _run(["--device", "cpu"], monkeypatch)
    assert rc == 0
    assert order == [("committee", "cpu"), ("epoch", "cpu")]
    assert [ln["mode"] for ln in lines] == ["committee", "epoch"]
    rc, lines = _run(["--device", "cpu"], monkeypatch,
                     {"BENCH_MODE": "epoch"})
    assert [ln["mode"] for ln in lines] == ["epoch"]


def test_python_dash_m_runs_the_entry():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "consensus_specs_tpu_torch.bench", "--mode",
         "finalexp"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 2, res.stderr
    assert json.loads(res.stdout)["mode"] == "finalexp"


def test_profiling_enabled_and_report_match_the_jax_package(monkeypatch):
    """``enabled()`` follows the environment on every call, and ``report()``
    renders the same records as the JAX package's does."""
    from consensus_specs_tpu.ops import profiling as jprof
    from consensus_specs_tpu_torch.ops import profiling as tprof

    for prof in (jprof, tprof):
        monkeypatch.delenv("CONSENSUS_SPECS_TPU_PROFILE", raising=False)
        assert prof.enabled() is False
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_PROFILE", "1")
        assert prof.enabled() is True
        prof.reset()
        prof.record("vm[steps=8]", 0.25)
        prof.record("vm[steps=8]", 0.5)
        prof.set_gauge("bls.final_exps", 3)
    try:
        assert tprof.report() == jprof.report()
        assert "vm[steps=8]: 2 calls" in tprof.report()
    finally:
        jprof.reset()
        tprof.reset()
