"""The port's spec-test harness (``consensus_specs_tpu_torch/test/context.py``
and ``test/harness.py``) behaves as the JAX package's ``context`` does:
each case drives both packages' decorators on the same body and holds
the port's observations equal to the JAX package's."""
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
JAX_PHASE0 = os.path.join(REPO, "consensus_specs_tpu", "test", "phase0")


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


def test_always_bls_cases_picked_by_attribute_match_the_jax_sources():
    """The chip smoke picks the ``@always_bls`` cases by the attribute the
    port's decorators carry outward; the pick must be the JAX package's
    ``@always_bls`` functions under test/phase0, name for name."""
    import importlib
    import pkgutil

    from consensus_specs_tpu_torch.test import phase0

    picked = set()
    for info in pkgutil.walk_packages(phase0.__path__, phase0.__name__ + "."):
        module = importlib.import_module(info.name)
        rel = info.name[len(phase0.__name__) + 1:]
        picked.update((rel, name) for name in harness.always_bls_names(module))
    in_sources = set()
    for root, _, files in os.walk(JAX_PHASE0):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, JAX_PHASE0)[:-3].replace(os.sep, ".")
            src = open(path).read()
            for match in re.finditer(r"^@always_bls\n(?:@.*\n)*def (test_\w+)", src, re.M):
                in_sources.add((rel, match.group(1)))
    assert len(in_sources) == 50
    assert picked == in_sources
