"""The port's spec-test harness (``consensus_specs_tpu_torch/test/context.py``
and ``test/harness.py``) behaves as the JAX package's ``context`` does:
each case drives both packages' decorators on the same body and holds
the port's observations equal to the JAX package's."""
import importlib
import os
import re

import pytest

from consensus_specs_tpu import builder as jax_builder
from consensus_specs_tpu.test import context as jax_context
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu_torch import builder as port_builder
from consensus_specs_tpu_torch.test import context as port_context
from consensus_specs_tpu_torch.test import harness
from consensus_specs_tpu_torch.test.harness import port_harness  # noqa: F401
from consensus_specs_tpu_torch.utils import bls as port_bls

PACKAGES = {
    "jax": (jax_context, jax_bls, jax_builder),
    "port": (port_context, port_bls, port_builder),
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TEST = os.path.join(REPO, "consensus_specs_tpu", "test")


def _each_package(check):
    """``check(context, bls, builder)`` on both packages; the port's
    observation must equal the JAX package's."""
    seen = {name: check(*mods) for name, mods in PACKAGES.items()}
    assert seen["port"] == seen["jax"]
    return seen["port"]


def test_bls_switch_restores_bls_active_after_a_raise():
    def check(context, bls, builder):
        inside = []

        def body(spec, state):
            inside.append(bls.bls_active)
            raise RuntimeError("the test failed")
            yield  # unreachable: makes the body a generator, as a spec test is

        # the spec tests' own order: @always_bls below @spec_state_test
        case = context.with_phases([context.PHASE0])(
            context.spec_state_test(context.always_bls(body)))
        saved = bls.bls_active
        bls.bls_active = False
        try:
            with pytest.raises(RuntimeError):
                case(generator_mode=True, phase="phase0", preset="minimal",
                     bls_active=False)
            after = bls.bls_active
        finally:
            bls.bls_active = saved
        return inside, after

    assert _each_package(check) == ([True], False)


def test_with_config_overrides_restores_config_after_a_raise():
    def check(context, bls, builder):
        spec = builder.build_spec_module("phase0", "minimal")
        old = spec.config
        inside = []

        def body(spec):
            inside.append(int(spec.config.SHARD_COMMITTEE_PERIOD))
            raise RuntimeError("the test failed")
            yield  # unreachable: makes the body a generator

        case = context.with_config_overrides({"SHARD_COMMITTEE_PERIOD": 1})(body)
        with pytest.raises(RuntimeError):
            list(case(spec=spec))
        return (inside, spec.config is old,
                int(spec.config.SHARD_COMMITTEE_PERIOD))

    assert _each_package(check) == ([1], True, 64)


def test_genesis_state_writes_never_reach_the_cache_or_a_later_test():
    def check(context, bls, builder):
        spec = builder.build_spec_module("phase0", "minimal")
        first = context.get_genesis_state(
            spec, context.default_balances, context.default_activation_threshold)
        root = bytes(first.hash_tree_root())
        # nested views: a write through a list element must stay local
        first.validators[0].slashed = True
        first.validators[1].effective_balance = 1
        first.balances[2] = 3
        first.slot = 9
        second = context.get_genesis_state(
            spec, context.default_balances, context.default_activation_threshold)
        seen = []

        def mutate(spec, state):
            state.validators[3].exit_epoch = 7
            state.randao_mixes[0] = b"\x01" * 32
            seen.append(bytes(state.hash_tree_root()))
            yield "post", state

        def later(spec, state):
            seen.append(bytes(state.hash_tree_root()))
            yield "post", state

        for body in (mutate, later):
            context.with_phases([context.PHASE0])(context.spec_state_test(body))()
        return (bytes(second.hash_tree_root()) == root,
                bool(second.validators[0].slashed),
                seen[0] != root, seen[1] == root,
                bool(first.validators[0].slashed), root.hex())

    same, slashed, mutated, clean, local, _ = _each_package(check)
    assert (same, slashed, mutated, clean, local) == (True, False, True, True, True)


def test_vector_test_keeps_the_bytes_of_a_view_at_its_yield():
    def check(context, bls, builder):
        def body(spec, state):
            yield "pre", state
            block = spec.BeaconBlock(slot=state.slot + 1)
            yield "blocks", [block]
            yield "config", "meta", {"mutable": [1]}
            yield "scratch", {"mutable": [1]}
            block.slot += 5
            state.slot += 1
            state.validators[0].slashed = True
            yield "post", state

        case = context.with_phases([context.PHASE0])(context.spec_state_test(body))
        parts = case(generator_mode=True, phase="phase0", preset="minimal",
                     bls_active=False)
        by_name = {name: value for name, _, value in parts}
        spec = builder.build_spec_module("phase0", "minimal")
        pre = spec.BeaconState.decode_bytes(by_name["pre"])
        post = spec.BeaconState.decode_bytes(by_name["post"])
        block = spec.BeaconBlock.decode_bytes(by_name["blocks_0"])
        return ([(name, kind) for name, kind, _ in parts],
                int(pre.slot), bool(pre.validators[0].slashed),
                int(post.slot), bool(post.validators[0].slashed),
                int(block.slot), by_name["scratch"],
                [bytes(v).hex() if isinstance(v, bytes) else v
                 for _, _, v in parts])

    names, pre_slot, pre_slashed, post_slot, post_slashed, block_slot, scratch, _ = \
        _each_package(check)
    assert names == [("pre", "ssz"), ("blocks_0", "ssz"), ("blocks_count", "meta"),
                     ("config", "meta"), ("scratch", "data"), ("post", "ssz")]
    assert (pre_slot, pre_slashed, post_slot, post_slashed, block_slot) == \
        (0, False, 1, True, 1)
    assert scratch == {"mutable": [1]}


@pytest.mark.parametrize("mode", ["pytest", "generator"])
def test_with_presets_and_only_generator_skip_alike(mode):
    def check(context, bls, builder):
        def body(spec, state):
            yield "post", state

        other = context.MAINNET if context.DEFAULT_TEST_PRESET == context.MINIMAL \
            else context.MINIMAL
        cases = [
            context.with_phases([context.PHASE0])(
                context.with_presets([other], reason="needs the other preset")(
                    context.spec_state_test(body))),
            context.with_phases([context.PHASE0])(
                context.with_presets([context.DEFAULT_TEST_PRESET])(
                    context.spec_state_test(body))),
            context.with_phases([context.PHASE0])(
                context.only_generator("vectors only")(context.spec_state_test(body))),
        ]
        outcomes = []
        for case in cases:
            if mode == "generator":
                outcome = harness.run_case(case, "phase0", context.DEFAULT_TEST_PRESET,
                                           False)
            else:
                try:
                    outcome = ("ran", case())
                except pytest.skip.Exception as exc:
                    outcome = ("skip", str(exc))
            outcomes.append((outcome[0], outcome[1] if outcome[0] == "skip" else None))
        return outcomes

    ran = "parts" if mode == "generator" else "ran"
    assert _each_package(check) == [
        ("skip", "needs the other preset"),
        (ran, None),
        ("skip", "vectors only") if mode == "pytest" else (ran, None),
    ]


def test_port_harness_sets_the_port_defaults(request):
    preset = request.config.getoption("--preset")
    assert port_context.DEFAULT_TEST_PRESET == preset == jax_context.DEFAULT_TEST_PRESET
    assert port_context.DEFAULT_BLS_ACTIVE == jax_context.DEFAULT_BLS_ACTIVE
    assert port_context.DEFAULT_PYTEST_FORKS == jax_context.DEFAULT_PYTEST_FORKS
    assert port_bls.backend_name() == "py_ecc"


def _jax_sources(fork):
    """(module path relative to the fork's package, source) of every JAX
    spec-test module of ``fork``."""
    top = os.path.join(JAX_TEST, fork)
    for root, _, files in sorted(os.walk(top)):
        for fname in sorted(files):
            if fname.endswith(".py"):
                path = os.path.join(root, fname)
                rel = os.path.relpath(path, top)[:-3].replace(os.sep, ".")
                yield rel, open(path).read()


def _port_modules(fork):
    """(module path relative to the fork's package, module) of every port
    spec-test module of ``fork``."""
    import importlib
    import pkgutil

    package = importlib.import_module(f"consensus_specs_tpu_torch.test.{fork}")
    for info in pkgutil.walk_packages(package.__path__, package.__name__ + "."):
        yield info.name[len(package.__name__) + 1:], importlib.import_module(info.name)


@pytest.mark.parametrize("fork,count", [("phase0", 50), ("altair", 22)])
def test_always_bls_cases_picked_by_attribute_match_the_jax_sources(fork, count):
    """The chip smoke picks the ``@always_bls`` cases by the attribute the
    port's decorators carry outward; the pick must be the JAX package's
    ``@always_bls`` functions under test/<fork>, name for name (72 in
    all; merge has none)."""
    picked = {(rel, name) for rel, module in _port_modules(fork)
              for name in harness.always_bls_names(module)}
    in_sources = {(rel, match.group(1)) for rel, src in _jax_sources(fork)
                  for match in re.finditer(
                      r"^@always_bls\n(?:@.*\n)*def (test_\w+)", src, re.M)}
    assert len(in_sources) == count
    assert picked == in_sources


def _decorated_forks(src):
    """{case name: forks of context.ALL_PHASES} read from the decorators of
    a JAX spec-test module's source: ``with_phases``' first argument (a
    list of fork constants, or a module-level name bound to one) or
    ``fork_transition_test``'s pre-fork."""
    import ast

    consts = {"PHASE0": "phase0", "ALTAIR": "altair", "MERGE": "merge",
              "SHARDING": "sharding", "CUSTODY_GAME": "custody_game"}
    tree = ast.parse(src)
    lists = {node.targets[0].id: [consts[e.id] for e in node.value.elts]
             for node in tree.body
             if isinstance(node, ast.Assign) and isinstance(node.value, ast.List)
             and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)}
    forks = {}
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef) and node.name.startswith("test_")):
            continue
        for deco in node.decorator_list:
            if not (isinstance(deco, ast.Call) and isinstance(deco.func, ast.Name)):
                continue
            if deco.func.id == "with_phases":
                arg = deco.args[0]
                phases = (lists[arg.id] if isinstance(arg, ast.Name)
                          else [consts[e.id] for e in arg.elts])
            elif deco.func.id == "fork_transition_test":
                phases = [consts[deco.args[0].id]]
            else:
                continue
            forks[node.name] = [f for f in jax_context.ALL_PHASES if f in phases]
    return forks


def test_enumerated_runs_match_the_jax_sources_with_phases():
    """The (module, case, fork) runs the altair and merge comparison files
    parametrise over (``harness.covered_forks`` of each case, on both
    packages) equal the forks of a scan of the JAX sources' decorators:
    233 runs, the twelve ``_ALTAIR_ON`` cases on altair and on merge."""
    scanned, enumerated = set(), set()
    for fork in ("altair", "merge"):
        scanned |= {(fork, rel, name, f) for rel, src in _jax_sources(fork)
                    for name, forks in _decorated_forks(src).items()
                    for f in forks}
        for rel, module in _port_modules(fork):
            expected = importlib.import_module(
                f"consensus_specs_tpu.test.{fork}.{rel}")
            for name in harness.case_names(module):
                forks = harness.covered_forks(getattr(module, name))
                assert forks == harness.covered_forks(getattr(expected, name))
                enumerated |= {(fork, rel, name, f) for f in forks}
    assert len(scanned) == 233
    assert sum(f == "merge" for fork, _, _, f in scanned if fork == "altair") == 12
    assert enumerated == scanned


def test_a_fork_the_case_does_not_cover_gives_none_in_both_packages():
    """In generator mode a case returns ``None`` on a fork its
    ``with_phases`` (or ``fork_transition_test``) does not cover."""
    cases = [("merge.unittests.test_transition_predicates",
              "test_is_merge_complete_tracks_header", ("phase0", "altair")),
             ("altair.unittests.test_config_invariants", "test_weights",
              ("phase0", "merge")),
             ("altair.transition.test_transition",
              "test_normal_transition_to_altair", ("altair", "merge"))]
    for rel, name, forks in cases:
        for package in ("consensus_specs_tpu", "consensus_specs_tpu_torch"):
            fn = getattr(importlib.import_module(f"{package}.test.{rel}"), name)
            for fork in forks:
                assert fork not in harness.covered_forks(fn)
                assert harness.run_case(fn, fork, "minimal", False) == \
                    ("parts", None)


def test_hold_case_runs_the_fork_it_is_given():
    from consensus_specs_tpu.test.altair.unittests import (
        test_config_invariants as jax_invariants,
    )
    from consensus_specs_tpu_torch.test.altair.unittests import (
        test_config_invariants as port_invariants,
    )

    expected, port = jax_invariants.test_weights, port_invariants.test_weights
    harness.hold_case(expected, port, "altair")
    outcome = harness.run_case(port, "altair", "minimal", False)
    assert outcome[0] == "parts" and outcome[1] is not None  # it ran
    # on a fork it does not cover both give None, which holds too
    harness.hold_case(expected, port, "merge")
    # a different outcome is caught: a merge case gives None on altair
    from consensus_specs_tpu_torch.test.merge.unittests import (
        test_transition_predicates as port_predicates,
    )

    with pytest.raises(AssertionError):
        harness.hold_case(expected,
                          port_predicates.test_is_merge_complete_tracks_header,
                          "altair")
