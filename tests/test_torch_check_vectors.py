"""tools/torch_check_vectors.py, the port's vector-tree checker, against
tools/check_vectors.py on one tree.

The port's ``ssz_generic`` and ``shuffling -l minimal`` generators write a
small tree; one case then gets an ``INCOMPLETE`` sentinel and one
``ssz_snappy`` part is cut short. Both tools must find the same counts,
sentinels, empty cases and parts, the same undecodable part, the same
report and the same verdict (FAIL), and both must pass the clean tree.
"""
import importlib
import importlib.util
import os
import subprocess
import sys

import pytest

from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vectors")
    for name, args in (("ssz_generic", []), ("shuffling", ["-l", "minimal"])):
        gen = importlib.import_module(
            f"consensus_specs_tpu_torch.gen.generators.{name}")
        assert gen.main(["-o", str(root)] + args) == 0
    return root


def _scan(tool, root, sample):
    counts, incomplete, empty, parts = tool.scan_tree(str(root))
    failures = tool.sample_decode_failures(parts, sample)
    ok = not incomplete and not empty and bool(counts) and not failures
    return (counts, incomplete, empty, parts,
            [(os.path.relpath(p, root), err) for p, err in failures], ok,
            tool.render_report(counts, incomplete, empty, parts, ok))


def _cli(tool, root, report):
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"), str(root),
         "--decode-sample", "100000", "--report", str(report)],
        capture_output=True, text=True, timeout=300)
    out = run.stdout.replace(str(report), "REPORT")
    return run.returncode, out, report.read_text()


def test_clean_tree_same_verdict(tree, tmp_path):
    jax_tool, port_tool = _load("check_vectors"), _load("torch_check_vectors")
    want = _scan(jax_tool, tree, 100000)
    assert _scan(port_tool, tree, 100000) == want
    counts, incomplete, empty, parts, failures, ok, _ = want
    assert ok and not failures and not incomplete and not empty
    assert {runner for _, _, runner in counts} == {"ssz_generic", "shuffling"}
    assert parts
    assert _cli("torch_check_vectors", tree, tmp_path / "port.md") == \
        _cli("check_vectors", tree, tmp_path / "jax.md")


def test_planted_faults_same_findings(tree, tmp_path):
    """One INCOMPLETE sentinel and one truncated ssz_snappy part, in a copy
    of the tree: both tools flag both, alike, and fail."""
    import shutil

    root = tmp_path / "planted"
    shutil.copytree(tree, root)
    _, _, _, parts = _load("torch_check_vectors").scan_tree(str(root))
    bad = sorted(parts)[0]
    with open(bad, "rb") as fh:
        data = fh.read()
    with open(bad, "wb") as fh:
        fh.write(data[:len(data) // 2])
    case = sorted(os.path.dirname(p) for p in parts)[-1]
    open(os.path.join(case, "INCOMPLETE"), "w").close()

    jax_tool, port_tool = _load("check_vectors"), _load("torch_check_vectors")
    want = _scan(jax_tool, root, 100000)
    assert _scan(port_tool, root, 100000) == want
    counts, incomplete, empty, parts, failures, ok, report = want
    assert not ok and "verdict: **FAIL**" in report
    assert incomplete == [os.path.relpath(case, root)]
    assert [path for path, _ in failures] == [os.path.relpath(bad, root)]
    jax_cli = _cli("check_vectors", root, tmp_path / "jax.md")
    assert _cli("torch_check_vectors", root, tmp_path / "port.md") == jax_cli
    assert jax_cli[0] == 1
