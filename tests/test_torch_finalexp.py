"""The port's finalexp bench (consensus_specs_tpu_torch/bench/finalexp.py)
through the bench entry on the CPU at rows 1 (and the fused race at 1
row): one line whose sections carry the JAX bench's keys (read from the
JAX module's source), every cell ok, the bars computed, the JAX
package's critical paths, no kernel launched on the CPU, and the caller's
CONSENSUS_SPECS_TPU_VM_EXEC restored after the fused cells."""
import ast
import contextlib
import io
import json
import os

from tests.torch_threads import one_thread

one_thread()

JAX_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "consensus_specs_tpu", "bench", "finalexp.py")


def _jax_result_keys():
    """The keywords of the JAX bench's ``return dict(...)``, and the keys
    of its ``bars`` and ``assembler`` dict literals."""
    tree = ast.parse(open(JAX_BENCH).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_finalexp_bench")
    ret = next(n for n in fn.body if isinstance(n, ast.Return))
    keys = {kw.arg for kw in ret.value.keywords}
    literals = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("bars", "assembler")):
            literals[node.targets[0].id] = {k.value for k in node.value.keys}
    return keys, literals["bars"], literals["assembler"]


def test_finalexp_mode_on_the_cpu(monkeypatch, tmp_path):
    from consensus_specs_tpu_torch.bench import entry

    for k, v in {"FINALEXP_ROWS": "1", "FINALEXP_FUSED_ROWS": "1",
                 "CONSENSUS_SPECS_TPU_VM_EXEC": "interp",
                 "CONSENSUS_SPECS_TPU_VM_CACHE": str(tmp_path / "cache")
                 }.items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry.main(["--mode", "finalexp", "--device", "cpu"])
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    assert rc == 0 and len(lines) == 1, lines
    line = lines[0]
    assert "error" not in line
    keys, bar_keys, assembler_keys = _jax_result_keys()
    assert keys - {"value", "vs_baseline"} <= set(line)
    assert set(line) - keys == {"unit", "platform", "device", "launches",
                                "seconds"}
    assert line["mode"] == "finalexp" and line["platform"] == "cpu"
    assert line["device"] is None and line["rows"] == [1]
    assert line["final"] == "host"
    cells = line["finalexp"]
    assert set(cells) == {f"{v},1" for v in (
        "host", "bit_serial", "windowed", "frobenius", "frobenius_interp1",
        "frobenius_fused")}
    assert all(c["ok"] and c["ms_per_row"] > 0 for c in cells.values()), cells
    assert set(line["bars"]) == (bar_keys | {"fused_3x_1"})
    assert all(isinstance(b, bool) for b in line["bars"].values())
    assert line["bars"]["depth_2_5x"] is True  # 4864 >= 2.5 x 1840
    assert line["crit_path"] == {"bit_serial": 4740, "windowed": 2109,
                                 "frobenius": 1840, "legacy_padded": 4864,
                                 "best_ratio": 2.64}
    assert set(line["assembler"]) == assembler_keys
    assert line["assembler"]["native_kernel"] is True
    assert line["launches"] == {"vm_step": 0, "vm_step_steps": 0,
                                "mont_mul": 0, "pow_chain": 0}
    assert os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] == "interp"
