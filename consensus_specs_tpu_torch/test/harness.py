"""The pytest harness of the port's spec tests, and the case runner that
holds one spec-test function against a twin.

``port_harness`` is an autouse fixture: a test module that imports it
runs every test with the port's ``context`` defaults taken from the
options that ``tests/conftest.py`` registers (``--preset``, ``--fork``,
``--enable-bls``) and the switchboard on the CPU oracle, or on the card
with ``--bls-type gpu`` (which raises without one: no fallback). The
switchboard's backend and ``bls_active`` are restored afterwards.

``run_case`` calls a test function the way the vector generators do
(``generator_mode=True`` with an explicit fork, preset and BLS switch) and
returns its outcome: its part list, a skip with its reason, or the type
of what it raised. ``assert_same_outcome`` holds two outcomes equal part
by part. Neither knows which package a function came from.
"""
import inspect

import pytest

from ..utils import bls
from . import context


@pytest.fixture(autouse=True)
def port_harness(request):
    saved = (context.DEFAULT_TEST_PRESET, context.DEFAULT_PYTEST_FORKS,
             context.DEFAULT_BLS_ACTIVE, bls._backend, bls.bls_active)
    option = request.config.getoption
    context.DEFAULT_TEST_PRESET = option("--preset")
    forks = option("--fork")
    context.DEFAULT_PYTEST_FORKS = set(forks) if forks else None
    # BLS off except @always_bls, unless --enable-bls (reference Makefile:100)
    context.DEFAULT_BLS_ACTIVE = bool(option("--enable-bls"))
    if option("--bls-type") == "gpu":
        bls.use_gpu()
    else:
        bls.use_py_ecc()
    try:
        yield
    finally:
        (context.DEFAULT_TEST_PRESET, context.DEFAULT_PYTEST_FORKS,
         context.DEFAULT_BLS_ACTIVE, bls._backend, bls.bls_active) = saved


def case_names(module):
    """The ``test_*`` functions of a spec-test module, sorted by name (the
    vector generators' enumeration, gen/gen_from_tests.py)."""
    return sorted(name for name, _ in inspect.getmembers(module, inspect.isfunction)
                  if name.startswith("test_"))


def always_bls_names(module):
    """The ``@always_bls`` cases of a module (``context._wraps`` carries
    the decorator's ``bls_setting`` outward)."""
    return [name for name in case_names(module)
            if getattr(getattr(module, name), "bls_setting", None) == 1]


def run_case(fn, phase, preset, bls_active):
    """("parts", [(name, kind, value), ...] or None), ("skip", reason) or
    ("raise", exception type name)."""
    try:
        parts = fn(generator_mode=True, phase=phase, preset=preset,
                   bls_active=bls_active)
    except pytest.skip.Exception as exc:
        return ("skip", str(exc))
    except Exception as exc:  # noqa: BLE001 - the type is the outcome
        return ("raise", type(exc).__name__)
    return ("parts", None if parts is None else list(parts))


def paired_cases(modules, part=0, parts=1):
    """(key, case name) for every ``test_*`` function of the first module
    of each ``{key: (expected module, port module)}`` entry; with
    ``parts`` > 1 only every ``parts``-th of them from ``part`` on (one
    module's cases split over several test files)."""
    cases = [(key, name) for key, (expected, _) in modules.items()
             for name in case_names(expected)]
    return cases[part::parts]


def hold_case(expected_fn, port_fn):
    """Run both functions on phase0 at the harness's preset and BLS
    default, hold the port's outcome equal to the expected one, and skip
    (with the common reason) where both skipped."""
    args = (context.PHASE0, context.DEFAULT_TEST_PRESET,
            context.DEFAULT_BLS_ACTIVE)
    expected = run_case(expected_fn, *args)
    got = run_case(port_fn, *args)
    assert_same_outcome(expected, got)
    if expected[0] == "skip":
        pytest.skip(expected[1])


def assert_same_outcome(expected, got):
    """Names, kinds and order equal; ``ssz`` and ``bytes`` parts byte-equal;
    ``data`` and ``meta`` parts ``==``."""
    assert got[0] == expected[0], (expected, got)
    if expected[0] != "parts" or expected[1] is None or got[1] is None:
        assert got == expected
        return
    want, have = expected[1], got[1]
    assert [(p[0], p[1]) for p in have] == [(p[0], p[1]) for p in want]
    for (name, kind, a), (_, _, b) in zip(want, have):
        if kind in ("ssz", "bytes"):
            assert bytes(b) == bytes(a), f"part {name} ({kind}) differs"
        else:
            assert b == a, f"part {name} ({kind}) differs: {a!r} != {b!r}"
