"""tools/torch_speclint.py, the port's lint gate, against tools/speclint.py.

The seeded cases of tests/test_speclint.py (stale call sites, legal call
shapes, duplicate definitions and their exemptions), a seeded source file
and a seeded built-spec namespace go through both tools; their findings
must be equal, and as many as tests/test_speclint.py expects. The
port's twin walks only the port's files, builds the port's specs, and
finds nothing in this tree.
"""
import importlib.util
import os
import textwrap
import types

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
def tools():
    return _load("speclint"), _load("torch_speclint")


# tests/test_speclint.py's seeded call-site cases: (source, findings)
CALL_CASES = {
    "wrong_arity": ("""
        def helper(state, index):
            return index

        def process_thing(state):
            return helper(state)  # stale call site: missing 'index'
        """, 1),
    "unknown_keyword": ("""
        def helper(state, index=0):
            return index

        def process_thing(state):
            return helper(state, idx=3)  # typo'd keyword
        """, 1),
    "too_many_positionals": ("""
        def helper(state):
            return state

        def process_thing(state):
            return helper(state, 1, 2)
        """, 1),
    "legal_shapes": ("""
        def helper(state, index=0, *, flag=False):
            return index

        def uses_default(state):
            return helper(state)

        def uses_keyword(state):
            return helper(state, index=2, flag=True)

        def uses_splat(state, args):
            return helper(*args)  # unknowable statically: skipped

        def shadows(state):
            helper = len  # local shadow: the ns function is NOT the callee
            return helper(state)
        """, 0),
    "non_function_callee": ("""
        class Thing:
            def __init__(self, a, b):
                pass

        def make(state):
            return Thing(1, 2, 3)  # classes use a different convention
        """, 0),
}

# tests/test_speclint.py's seeded duplicate-definition cases
DUP_CASES = {
    "duplicate_test": ("""
        def test_x():
            assert True

        def test_x():  # the classic: the first test silently never runs
            assert False
        """, 1),
    "duplicate_class_and_method": ("""
        class C:
            def m(self):
                return 1

            def m(self):
                return 2

        class C:
            pass
        """, 2),
    "branch_split": ("""
        try:
            from fast import impl
        except ImportError:
            def impl():
                return None

        if True:
            def helper():
                return 1
        else:
            def helper():
                return 2
        """, 0),
    "inside_else_branch": ("""
        try:
            import fast
        except ImportError:
            pass
        else:
            def test_x():
                assert True

            def test_x():
                assert False
        """, 1),
    "property_setter": ("""
        class C:
            @property
            def x(self):
                return self._x

            @x.setter
            def x(self, v):
                self._x = v
        """, 0),
    "mark_decorated": ("""
        import pytest

        @pytest.mark.slow
        def test_x():
            assert True

        @pytest.mark.slow
        def test_x():
            assert False
        """, 1),
    "noqa": ("""
        def f():
            return 1

        def f():  # noqa: deliberate override
            return 2
        """, 0),
}


def _ns(src, tmp_path, name):
    """``src`` exec'd against a real file, as the builder execs a spec."""
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(src))
    ns = {}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns


@pytest.mark.parametrize("case", sorted(CALL_CASES))
def test_call_signature_findings_equal(tools, tmp_path, case):
    src, count = CALL_CASES[case]
    ns = _ns(src, tmp_path, case)
    jax_lint, port_lint = tools
    want = jax_lint.check_call_signatures(ns, "<seeded>")
    assert port_lint.check_call_signatures(ns, "<seeded>") == want
    assert len(want) == count


@pytest.mark.parametrize("case", sorted(DUP_CASES))
def test_duplicate_definition_findings_equal(tools, case):
    import ast

    src, count = DUP_CASES[case]
    src = textwrap.dedent(src)
    noqa = {i + 1 for i, line in enumerate(src.splitlines()) if "noqa" in line}
    jax_lint, port_lint = tools
    want = jax_lint.check_duplicate_defs(ast.parse(src), "mod.py", noqa)
    assert port_lint.check_duplicate_defs(ast.parse(src), "mod.py",
                                          noqa) == want
    assert len(want) == count


def test_source_file_findings_equal(tools, tmp_path):
    """An undefined name, an unused import and a duplicate definition in
    one file outside either package: the same three findings."""
    path = tmp_path / "seeded_source.py"
    path.write_text(textwrap.dedent("""
        import os
        import sys


        def f():
            return sys.argv + undefined_thing


        def f():
            return 2
        """))
    jax_lint, port_lint = tools
    want = jax_lint.check_source_file(str(path))
    assert port_lint.check_source_file(str(path)) == want
    assert len(want) == 3
    assert any("unused import 'os'" in f for f in want)
    assert any("undefined name 'undefined_thing'" in f for f in want)


SEEDED_SPEC = """
class Checkpoint(Container):
    epoch: uint64
    root: int  # not an SSZ view


def get_epoch(state) -> uint64:
    return missing_helper(state)


def process(state) -> "Unknown":
    return get_epoch(state, 1)
"""


def test_built_spec_findings_equal(tools, tmp_path, monkeypatch):
    """A built namespace with an unresolvable reference, an unresolvable
    annotation, a stale call site and a non-View container field, each
    tool on its own package's SSZ classes: the same four findings."""
    from consensus_specs_tpu import builder as jax_builder
    from consensus_specs_tpu.utils.ssz import ssz_typing as jax_ssz
    from consensus_specs_tpu_torch import builder as port_builder
    from consensus_specs_tpu_torch.utils.ssz import ssz_typing as port_ssz

    found = []
    for lint, builder, ssz in ((tools[0], jax_builder, jax_ssz),
                               (tools[1], port_builder, port_ssz)):
        path = tmp_path / f"seeded_spec_{len(found)}.py"
        path.write_text(SEEDED_SPEC)
        mod = types.ModuleType("seeded_spec")
        mod.Container, mod.uint64 = ssz.Container, ssz.uint64
        exec(compile(SEEDED_SPEC, str(path), "exec"), vars(mod))
        monkeypatch.setattr(builder, "build_spec_module",
                            lambda fork, preset, mod=mod: mod)
        found.append(lint.check_built_spec("phase0", "minimal"))
    want, got = found
    assert got == want and len(want) == 4


@pytest.mark.parametrize("fork", ["phase0", "altair", "merge"])
def test_built_specs_clean_alike(tools, fork):
    jax_lint, port_lint = tools
    assert port_lint.check_built_spec(fork, "minimal") == \
        jax_lint.check_built_spec(fork, "minimal") == []


def test_port_walk_covers_only_the_port(tools):
    files = [os.path.relpath(f, REPO) for f in tools[1]._py_files()]
    assert "chip_smoke.py" in files
    assert os.path.join("tools", "torch_speclint.py") in files
    assert os.path.join("tests", "test_torch_speclint.py") in files
    assert any(f.startswith("consensus_specs_tpu_torch" + os.sep)
               for f in files)
    assert not any(f.startswith("consensus_specs_tpu" + os.sep)
                   or f in ("bench.py", "__graft_entry__.py")
                   or os.path.basename(f) in ("speclint.py", "test_speclint.py")
                   for f in files)


def test_port_sources_and_specs_lint_clean(tools, monkeypatch, capsys):
    """The gate on this tree: the port's sources and its built specs give
    no finding (exit 0)."""
    monkeypatch.setattr("sys.argv", ["torch_speclint.py"])
    assert tools[1].main() == 0
    assert "torch_speclint: 0 finding(s)" in capsys.readouterr().out
