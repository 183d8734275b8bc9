"""The bench entry's mesh options on the CPU at tiny knobs: ``--mode
serve --mesh 2`` serves on a 2-slot mesh with no mesh fallback,
``--mode serve-mesh`` runs one serve child a slot count with every row
``ok``, and ``--mesh`` leaves no CONSENSUS_SPECS_TPU_MESH behind."""
import contextlib
import io
import json
import os

from tests.torch_threads import one_thread

one_thread()

SERVE_TINY = {"SERVE_EVENTS": "8", "SERVE_COMMITTEES": "2", "SERVE_K": "1",
              "SERVE_INJECT_FAILURE": "0"}


def _run(argv, monkeypatch, knobs=()):
    from consensus_specs_tpu_torch.bench import entry

    monkeypatch.delenv("CONSENSUS_SPECS_TPU_MESH", raising=False)
    for k, v in dict(knobs).items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry.main(list(argv) + ["--device", "cpu"])
    return rc, [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def test_serve_on_a_two_slot_mesh(monkeypatch):
    rc, lines = _run(["--mode", "serve", "--mesh", "2"], monkeypatch,
                     SERVE_TINY)
    assert rc == 0 and len(lines) == 1, lines
    line = lines[0]
    assert "error" not in line, line
    assert line["mode"] == "serve" and line["platform"] == "cpu"
    assert line["mesh_devices"] == 2 and line["mesh_fallbacks"] == 0
    assert line["mesh_distinct_devices"] == 1
    assert line["lost"] == line["wrong"] == line["fallback_items"] == 0
    assert {"cpu.0", "cpu.1"} <= set(line["devices"]["lanes"])
    assert "CONSENSUS_SPECS_TPU_MESH" not in os.environ


def test_serve_mesh_sweep_rows_ok(monkeypatch):
    rc, lines = _run(["--mode", "serve-mesh"], monkeypatch,
                     {**SERVE_TINY, "SERVE_INJECT_FAILURE": "1",
                      "SERVE_MESH_DEVICES": "1,2"})
    assert rc == 0 and len(lines) == 1, lines
    line = lines[0]
    assert line["mode"] == "serve-mesh" and line["device_counts"] == [1, 2]
    rows = line["mesh"]
    assert set(rows) == {"1", "2"}
    for d, row in rows.items():
        assert row["ok"] is True, (d, row)
        assert row["fallbacks"] == 0 and row["distinct_devices"] == 1
    assert rows["1"]["mesh_devices"] == 0 and rows["2"]["mesh_devices"] == 2
    assert "efficiency" in rows["2"] and line["value"] > 0


def test_committee_with_mesh_leaves_no_env_behind(monkeypatch):
    rc, lines = _run(["--mode", "committee", "--mesh", "2"], monkeypatch,
                     {"BENCH_N": "2", "BENCH_K": "1", "BENCH_REPS": "0"})
    assert rc == 0 and len(lines) == 1, lines
    assert lines[0]["verdicts_ok"] is True and "error" not in lines[0]
    assert "CONSENSUS_SPECS_TPU_MESH" not in os.environ
    rc, lines = _run(["--mode", "committee", "--mesh"], monkeypatch)
    assert rc == 2 and "slot count" in lines[0]["error"]
