"""The port's state-test generators against the JAX package's: for each
of the ten runners, one handler on one fork (its module path from the
generator's own table), a few of its cases through ``generate_from_tests``
and ``run_generator`` into two directories, the trees byte for byte equal
and every YAML part held against ``yaml.safe_dump``. BLS is off but in one
small handler run. Every case's parts are held one by one against the JAX
case in tests/test_torch_spec_*.py; this holds the writer path."""
import importlib
import os

import pytest
import yaml

from consensus_specs_tpu.gen import gen_from_tests as jax_from_tests
from consensus_specs_tpu.gen import gen_runner as jax_runner
from consensus_specs_tpu.gen import gen_typing as jax_typing
from consensus_specs_tpu.utils import bls as jax_switch
from consensus_specs_tpu_torch.gen import (
    gen_from_tests, gen_runner, gen_typing,
)
from consensus_specs_tpu_torch.utils import bls as port_switch
from tests.torch_threads import one_thread

one_thread()

# runner -> (fork, handler, cases, bls_active); the cheapest cases of the
# handler (sub-second on the CPU but finality's, forks' and transition's),
# transition_to_merge filtered (its case function returns None)
SELECTIONS = {
    "operations": ("phase0", "voluntary_exit",
                   ("success", "validator_already_exited"), False),
    "epoch_processing": ("altair", "participation_flag_updates",
                         ("rotation_all_zeroed", "rotation_random_seed_a"),
                         False),
    "sanity": ("phase0", "slots", ("slots_1", "over_epoch_boundary"), False),
    "finality": ("phase0", "finality", ("finality_rule_4",), False),
    "fork_choice": ("phase0", "get_head",
                    ("genesis_head", "vote_moves_head_to_lighter_fork"),
                    False),
    "genesis": ("phase0", "initialization",
                ("is_valid_genesis_state_true",
                 "initialize_beacon_state_from_eth1"), False),
    "rewards": ("phase0", "basic", ("empty_attestations",), False),
    "random": ("phase0", "random", ("random_blocks_seed_6_low_balances",),
               False),
    "forks": ("phase0", "fork", ("upgrade_fresh_state",), False),
    "transition": ("phase0", "core",
                   ("normal_transition_to_merge",
                    "transition_with_slashed_validator_carried"), False),
    # the BLS-on run: the exit's signature checked by each package's oracle
    "operations+bls": ("phase0", "voluntary_exit", ("success",), True),
    # a draft fork's handler, from the sharding spec tests
    "operations+sharding": ("sharding", "shard_proposer_slashing",
                            ("shard_proposer_slashing_accepted",
                             "shard_proposer_slashing_already_slashed"),
                            False),
}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _provider(package, from_tests, typing, switch, runner, fork, handler,
              names, bls_active):
    gen = importlib.import_module(f"{package}.gen.generators.{runner}")
    paths = gen.ALL_MODS[fork][handler]
    paths = [paths] if isinstance(paths, str) else paths

    def make_cases():
        for path in paths:
            for case in from_tests.generate_from_tests(
                    runner, handler, importlib.import_module(path), fork,
                    "minimal", bls_active=bls_active):
                if case.case_name in names:
                    yield case

    return typing.TestProvider(prepare=switch.use_py_ecc,
                               make_cases=make_cases)


@pytest.mark.parametrize("key", list(SELECTIONS))
def test_state_runner_tree_equals_jax(tmp_path, monkeypatch, key):
    runner = key.split("+")[0]
    fork, handler, names, bls_active = SELECTIONS[key]
    written = []
    dump = gen_runner.yaml_dump

    def checked(value):
        text = dump(value)
        assert text == yaml.safe_dump(value, default_flow_style=None,
                                      sort_keys=False)
        written.append(text)
        return text

    monkeypatch.setattr(gen_runner, "yaml_dump", checked)
    monkeypatch.setattr(jax_switch, "_backend", jax_switch._backend)
    verified = []  # each package's pairing check of a signature
    for switch in (port_switch, jax_switch):
        core = switch._core_verify
        monkeypatch.setattr(switch, "_core_verify",
                            lambda *a, c=core, s=switch:
                            verified.append(s.__name__) or c(*a))
    saved = (port_switch._backend, port_switch.bls_active)
    args = ["-l", "minimal"]
    try:
        rc = gen_runner.run_generator(runner, [_provider(
            "consensus_specs_tpu_torch", gen_from_tests, gen_typing,
            port_switch, runner, fork, handler, names, bls_active)],
            args=["-o", str(tmp_path / "port")] + args)
    finally:
        port_switch._backend, port_switch.bls_active = saved
    assert rc == 0
    assert jax_runner.run_generator(runner, [_provider(
        "consensus_specs_tpu", jax_from_tests, jax_typing, jax_switch,
        runner, fork, handler, names, bls_active)],
        args=["-o", str(tmp_path / "jax")] + args) == 0
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    for rel in port:
        assert port[rel] == jax[rel], rel
    cases = {os.path.basename(os.path.dirname(rel)) for rel in port}
    want = {n for n in names if n != "normal_transition_to_merge"}
    assert cases == want
    assert all(rel.split(os.sep)[:4] == ["minimal", fork, runner, handler]
               for rel in port)
    assert len(written) == sum(rel.endswith(".yaml") for rel in port)
    # with BLS on, each package's oracle checked the exit's signature
    assert sorted(set(verified)) == (
        [jax_switch.__name__, port_switch.__name__] if bls_active else [])


def test_run_state_test_generators_restores_the_switchboard(tmp_path):
    """The runner pins the oracle for its span, then gives the card
    default back: a test session goes on after it."""
    saved = (port_switch._backend, port_switch.bls_active)
    port_switch._backend, port_switch.bls_active = None, False
    try:
        mods = {"phase0": {"slots": "consensus_specs_tpu_torch.test.phase0"
                                    ".sanity.test_slots"}}
        assert gen_from_tests.run_state_test_generators(
            "sanity", mods, args=["-o", str(tmp_path), "-l", "minimal",
                                  "-c"]) == 0
        assert (port_switch._backend, port_switch.bls_active) == (None, False)
    finally:
        port_switch._backend, port_switch.bls_active = saved
