"""The port's bench entry (``python -m consensus_specs_tpu_torch.bench``,
``bench/entry.main``) on the CPU: each mode not held against the JAX
package in tests/test_torch_bench.py prints one parseable line with
``bench.py``'s keys at tiny knobs (vmexec among them); the modes the port
does not have yet exit 2 naming their ROADMAP item; without a card and
without ``--device cpu`` it exits 1 with an error line, and so does the
finalexp mode on a cell that is not ok (its CPU run is in
tests/test_torch_finalexp.py); with no ``--mode`` it runs committee then
the epoch; and ``python -m`` runs it as a module."""
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
    (["--mode", "committee", "--mesh", "2"], "item 8"),
    (["--mode", "serve-mesh"], "item 8"),
    (["--mode", "serve", "--mesh", "4"], "item 8"),
])
def test_unported_modes_exit_2_naming_their_roadmap_item(argv, item,
                                                         monkeypatch):
    rc, lines = _run(argv + ["--device", "cpu"], monkeypatch)
    assert rc == 2 and len(lines) == 1
    assert "ROADMAP Queue 1 " + item in lines[0]["error"]
    assert lines[0]["value"] == 0.0


def test_finalexp_without_a_card_is_an_error_line_and_exit_1(monkeypatch):
    """The finalexp mode runs on the card: without one (and without
    ``--device cpu``) it prints an error line and exits 1."""
    from consensus_specs_tpu_torch.bench import finalexp

    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(finalexp, "run_finalexp_bench",
                        lambda device=None: ran.append(device))
    rc, lines = _run(["--mode", "finalexp"], monkeypatch)
    assert rc == 1 and len(lines) == 1
    assert lines[0]["mode"] == "finalexp"
    assert "no CUDA device" in lines[0]["error"]
    assert ran == []


def test_finalexp_cell_not_ok_is_an_error_line_and_exit_1(monkeypatch):
    """A finalexp cell that errored or gave a wrong verdict fails the
    mode; false bars do not."""
    from consensus_specs_tpu_torch.bench import finalexp

    def run(device=None):
        return {"value": 1.0, "vs_baseline": 0.1, "mode": "finalexp",
                "bars": {"fused_3x_1": False},
                "finalexp": {"host,1": {"ok": True, "ms_per_row": 1.0},
                             "windowed,1": {"ok": False, "ms_per_row": None,
                                            "error": "wrong verdict"}}}
    monkeypatch.setattr(finalexp, "run_finalexp_bench", run)
    rc, lines = _run(["--mode", "finalexp", "--device", "cpu"], monkeypatch)
    assert rc == 1 and len(lines) == 1
    assert "finalexp cells not ok" in lines[0]["error"]
    assert "windowed,1" in lines[0]["error"]
    good = run()
    good["finalexp"]["windowed,1"] = {"ok": True, "ms_per_row": 2.0}
    monkeypatch.setattr(finalexp, "run_finalexp_bench", lambda device=None:
                        good)
    rc, lines = _run(["--mode", "finalexp", "--device", "cpu"], monkeypatch)
    assert rc == 0 and lines[0]["bars"] == {"fused_3x_1": False}


@pytest.mark.parametrize("bench_mode,said", [
    ("vmexec", "picks one of ['committee', 'epoch']"),
    ("head", "picks one of ['committee', 'epoch']"),
    ("nosuch", "picks one of ['committee', 'epoch']"),
])
def test_bench_mode_names_a_stage_of_the_no_mode_run(bench_mode, said,
                                                     monkeypatch):
    rc, lines = _run(["--device", "cpu"], monkeypatch,
                     {"BENCH_MODE": bench_mode})
    assert rc == 2 and len(lines) == 1
    assert lines[0]["mode"] == bench_mode and said in lines[0]["error"]


VMEXEC_TINY = {"VMEXEC_KINDS": "g2_subgroup", "VMEXEC_ROWS": "1,2",
               "VMEXEC_REPS": "1", "VMEXEC_COLD": "dedup"}


def test_vmexec_mode_runs_on_the_cpu(monkeypatch, tmp_path):
    """The vmexec mode on the CPU at a small size: both routes on every
    cell, limb-identical, the auto route on the measured winner, and one
    cold child fused-ready against a fresh program cache."""
    from consensus_specs_tpu_torch.ops import vm_compile

    knobs = dict(VMEXEC_TINY,
                 CONSENSUS_SPECS_TPU_VM_CACHE=str(tmp_path / "cache"))
    try:
        rc, lines = _run(["--mode", "vmexec", "--device", "cpu"],
                         monkeypatch, knobs)
    finally:
        vm_compile.reset_fused_state()
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert set(KEYS) <= set(line) and "error" not in line
    assert line["mode"] == "vmexec" and line["platform"] == "cpu"
    assert line["ok"] is True and line["fused_fallbacks"] == 0
    assert set(line["vmexec"]) == {"g2_subgroup,1", "g2_subgroup,2",
                                   "cold,g2_subgroup"}
    for key in ("g2_subgroup,1", "g2_subgroup,2"):
        cell = line["vmexec"][key]
        assert cell["ok"] and cell["auto_ok"], cell
        assert cell["interp_ms_row"] > 0 and cell["fused_ms_row"] > 0
        assert cell["fused_launches"] == cell["interp_launches"] == 0
    cold = line["vmexec"]["cold,g2_subgroup"]
    assert cold["ok"] and cold["identical"] and cold["device"] == "cpu"
    assert cold["native_scheduler"] is True
    assert "CONSENSUS_SPECS_TPU_VM_EXEC" not in os.environ


def test_python_dash_m_runs_vmexec(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, VMEXEC_COLD="0",
               CONSENSUS_SPECS_TPU_VM_CACHE=str(tmp_path / "cache"),
               **{k: v for k, v in VMEXEC_TINY.items() if k != "VMEXEC_COLD"})
    res = subprocess.run(
        [sys.executable, "-m", "consensus_specs_tpu_torch.bench", "--mode",
         "vmexec", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout)
    assert line["mode"] == "vmexec" and line["ok"] is True


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
    """``python -m`` on a process that sees no card: the finalexp mode's
    error line, exit 1."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "consensus_specs_tpu_torch.bench", "--mode",
         "finalexp"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 1, res.stderr
    line = json.loads(res.stdout)
    assert line["mode"] == "finalexp" and "no CUDA device" in line["error"]


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
