"""Reflection bridge of the port: pytest-style spec tests -> generator
cases (the counterpart of consensus_specs_tpu/gen/gen_from_tests.py;
reference: gen_helpers/gen_from_tests/gen.py:13-132).

The same decorated test functions that pytest drains double as vector
emitters: calling one with ``generator_mode=True`` makes the decorator stack
return the typed parts instead (test/context.py vector_test).

``run_state_test_generators`` pins the switchboard to the pure-Python
oracle for the span of the run and restores its backend and
``bls_active`` after it: the port's switchboard defaults to the card,
and a process that goes on (a test session) keeps that default.
"""
import inspect
from importlib import import_module
from typing import Dict, Iterable

from .gen_typing import TestCase, TestProvider


def generate_from_tests(runner_name: str, handler_name: str, src,
                        fork_name: str, preset_name: str,
                        bls_active: bool = True) -> Iterable[TestCase]:
    """One TestCase per ``test_*`` function of a module, named without the
    ``test_`` prefix (reference gen.py:30-56)."""
    for name, fn in inspect.getmembers(src, inspect.isfunction):
        if not name.startswith("test_"):
            continue
        case_name = name[len("test_"):]

        def case_fn(fn=fn):
            return fn(
                generator_mode=True,
                preset=preset_name,
                phase=fork_name,
                bls_active=bls_active,
            )

        yield TestCase(
            fork_name=fork_name,
            preset_name=preset_name,
            runner_name=runner_name,
            handler_name=handler_name,
            suite_name=getattr(fn, "suite_name", "pyspec_tests"),
            case_name=case_name,
            case_fn=case_fn,
        )


def run_state_test_generators(runner_name: str,
                              all_mods: Dict[str, Dict[str, object]],
                              args=None) -> int:
    """``all_mods``: {fork: {handler: module path or list of paths}} — a
    list means several fork-specific test modules emit under ONE official
    handler name (reference gen.py:96-132; combine_mods merges same-key
    entries into lists for exactly this)."""
    from ..utils import bls
    from .gen_runner import run_generator

    def make_cases():
        for preset in ("minimal", "mainnet"):
            for fork, mods in all_mods.items():
                for handler, mod_paths in mods.items():
                    if isinstance(mod_paths, str):
                        mod_paths = [mod_paths]
                    for mod_path in mod_paths:
                        src = import_module(mod_path)
                        yield from generate_from_tests(
                            runner_name, handler, src, fork, preset
                        )

    def prepare():
        # pin the pure-python oracle backend (the reference prepares milagro,
        # gen.py:74-77; the port's fast backend is the card's, selected
        # explicitly per run instead)
        bls.use_py_ecc()

    saved = (bls._backend, bls.bls_active)
    provider = TestProvider(prepare=prepare, make_cases=make_cases)
    try:
        return run_generator(runner_name, [provider], args=args)
    finally:
        bls._backend, bls.bls_active = saved


def combine_mods(dict_1, dict_2):
    """Merge handler->module(s) maps; entries sharing a handler COMBINE into
    a list so all their tests emit under that handler
    (reference gen.py:114-132)."""
    def as_list(v):
        return list(v) if isinstance(v, (list, tuple)) else [v]

    out = {k: as_list(v) for k, v in dict_1.items()}
    for k, v in dict_2.items():
        out[k] = out.get(k, []) + as_list(v)
    return out
