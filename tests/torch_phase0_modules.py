"""The phase0 spec-test modules of the port's tests, in one table.

``MODULES`` merges the ``MODULES`` tables of the 15
``tests/test_torch_spec_phase0_*.py`` files: {key: (JAX module, port
module)} for all 28 modules of ``test/phase0/``. Those files run every
case on phase0; ``tests/test_torch_spec_phase0_on_altair_*.py`` and
``..._on_merge_*.py`` run the same cases on the later forks that
``with_all_phases`` also covers. ``RUNS_ON_LATER_FORK`` is how many of the
370 cases run on altair, and as many on merge.
"""
import glob
import importlib
import os

RUNS_ON_LATER_FORK = 318


def _merged():
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for path in sorted(glob.glob(os.path.join(here,
                                              "test_torch_spec_phase0_*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("test_torch_spec_phase0_on_"):
            continue
        for key, pair in importlib.import_module(f"tests.{name}").MODULES.items():
            assert out.setdefault(key, pair) == pair, key
    return out


MODULES = _merged()
