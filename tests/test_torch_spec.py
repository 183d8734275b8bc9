"""The port's executable spec (consensus_specs_tpu_torch/builder.py,
config/, specsrc/phase0, specsrc/altair and the test/helpers subset)
against the JAX package's, on the CPU.

The comparison is exact and never crosses class identity: configs compare
as dicts, spec constants by value and SSZ type name, states and blocks by
their serialized bytes and ``hash_tree_root``s. Blocks built by the JAX
package's helpers move into the port's spec by ``decode_bytes``. Every
spec here is minimal-preset and at most 64 validators; the wide worlds
run on the card (chip_smoke.py phase ``spec``).
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from consensus_specs_tpu import builder as jbuilder
from consensus_specs_tpu.config import config_util as jconfig
from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu_torch import batch_verify as tbv
from consensus_specs_tpu_torch import builder as tbuilder
from consensus_specs_tpu_torch.config import config_util as tconfig
from consensus_specs_tpu_torch.utils import bls as tbls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "presets", "*", "*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "*.yaml")))
BUILDS = [(f, p) for f in ("phase0", "altair") for p in ("minimal", "mainnet")]
N_VALIDATORS = 64


@pytest.fixture(autouse=True)
def _switchboards():
    """BLS on in both switchboards, the port's on the CPU oracle; every
    flag and backend restored after."""
    was = (jbls.bls_active, tbls.bls_active, tbls._backend)
    jbls.bls_active = tbls.bls_active = True
    tbls.use_py_ecc()
    yield
    jbls.bls_active, tbls.bls_active, tbls._backend = was


def _specs(fork, preset="minimal"):
    return (jbuilder.build_spec_module(fork, preset),
            tbuilder.build_spec_module(fork, preset))


# -- config: the port's flat reader against PyYAML and the JAX loader --------


@pytest.mark.parametrize("rel", FLAT_FILES)
def test_flat_reader_equals_the_jax_loader(rel):
    import yaml

    path = os.path.join(REPO, rel)
    with open(path) as f:
        assert tconfig.read_flat_yaml(path) == yaml.load(f, Loader=yaml.BaseLoader)
    assert tconfig.load_config_file(path) == jconfig.load_config_file(path)


@pytest.mark.parametrize("fork,preset", BUILDS + [("custody_game", "mainnet")])
def test_preset_lineage_equals_the_jax_loader(fork, preset):
    assert tconfig.load_preset_for_fork(preset, fork) == \
        jconfig.load_preset_for_fork(preset, fork)
    assert tconfig.load_defaults(preset) == jconfig.load_defaults(preset)


def test_flat_reader_quotes_comments_and_refusals(tmp_path):
    good = tmp_path / "good.yaml"
    good.write_text(
        "# a comment\n\n---\nA: 'it''s'  # trailing\nB: \"x\\ty\"\n"
        "C: 0x00ff # hex\nD: 12\nE:\nF: -1\nA: 'again'\n")
    assert tconfig.read_flat_yaml(good) == {
        "A": "again", "B": "x\ty", "C": "0x00ff", "D": "12", "E": "",
        "F": "-1"}
    for text in ("A:\n  - 1\n", "A: [1, 2]\n", "- 1\n", "A: 'open\n",
                 "A: 'x' y\n"):
        bad = tmp_path / "bad.yaml"
        bad.write_text(text)
        with pytest.raises(ValueError):
            tconfig.read_flat_yaml(bad)


def test_duplicate_preset_key_raises(tmp_path):
    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text("X: 1\n")
    b.write_text("Y: 2\nX: 3\n")
    with pytest.raises(KeyError, match="duplicate preset var 'X'"):
        tconfig.load_preset([a, b])
    with pytest.raises(KeyError, match="duplicate preset var 'X'"):
        jconfig.load_preset([a, b])


_NO_YAML = r"""
import json, sys
sys.modules["yaml"] = None  # any import of PyYAML now raises ImportError
from consensus_specs_tpu_torch import builder
from consensus_specs_tpu_torch.config import config_util
out = {}
for fork in ("phase0", "altair"):
    for preset in ("minimal", "mainnet"):
        spec = builder.build_spec_module(fork, preset)
        out[spec.__name__] = int(spec.SLOTS_PER_EPOCH)
out["defaults"] = {p: {k: v.hex() if isinstance(v, bytes) else v
                       for k, v in config_util.load_defaults(p).items()}
                   for p in ("minimal", "mainnet")}
try:
    import yaml
    out["yaml"] = "imported"
except ImportError:
    out["yaml"] = "blocked"
out["loaded"] = sorted(m for m, mod in sys.modules.items() if mod is not None
                       and (m in ("yaml", "jax") or m.startswith("consensus_specs_tpu.")))
print(json.dumps(out))
"""


def test_port_builds_every_spec_with_yaml_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_YAML], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["yaml"] == "blocked" and got["loaded"] == []
    assert got["consensus_specs_tpu_torch.phase0.minimal"] == 8
    assert got["consensus_specs_tpu_torch.altair.mainnet"] == 32
    for preset in ("minimal", "mainnet"):
        want = {k: v.hex() if isinstance(v, bytes) else v
                for k, v in jconfig.load_defaults(preset).items()}
        assert got["defaults"][preset] == want


# -- the built modules ---------------------------------------------------------


def _public(spec):
    return {n for n in vars(spec) if not n.startswith("_")}


def _constant(v):
    """(SSZ type name, value) of a spec constant, or None for a type, a
    function or a module."""
    if isinstance(v, bool) or not isinstance(v, (int, bytes, str)):
        return None
    return (type(v).__name__, bytes(v) if isinstance(v, bytes) else v)


@pytest.mark.parametrize("fork,preset", BUILDS)
def test_same_names_constants_and_config(fork, preset):
    jspec, tspec = _specs(fork, preset)
    assert tspec.__name__ == f"consensus_specs_tpu_torch.{fork}.{preset}"
    assert sys.modules[tspec.__name__] is tspec
    assert _public(tspec) == _public(jspec)
    n_constants = 0
    for name in sorted(_public(jspec)):
        want = _constant(getattr(jspec, name))
        if want is not None:
            assert _constant(getattr(tspec, name)) == want, name
            n_constants += 1
    assert n_constants > 60
    assert {k: _constant(v) or v for k, v in vars(tspec.config).items()} == \
        {k: _constant(v) or v for k, v in vars(jspec.config).items()}
    # same SSZ shapes: every container's default serializes and roots alike
    for name in ("BeaconState", "SignedBeaconBlock", "Attestation"):
        jd, td = getattr(jspec, name)(), getattr(tspec, name)()
        assert td.encode_bytes() == jd.encode_bytes()
        assert bytes(td.hash_tree_root()) == bytes(jd.hash_tree_root())


def test_built_module_binds_the_port_switchboard():
    jspec, tspec = _specs("phase0")
    assert tspec.bls is tbls
    assert jspec.bls is jbls
    assert tspec.fork == "phase0" and tspec.preset_base == "minimal"
    assert tbuilder.IMPLEMENTED_FORKS == ["phase0", "altair"]
    assert tbuilder.FORK_ORDER == jbuilder.FORK_ORDER
    # the optimizations the JAX builder applies
    assert hasattr(tspec.compute_shuffled_index, "__wrapped_raw__")
    assert tspec.compute_shuffled_index(5, 64, b"\x07" * 32) == \
        jspec.compute_shuffled_index(5, 64, b"\x07" * 32)
    altair = tbuilder.build_spec_module("altair", "minimal")
    assert "_eth_aggregate_pubkeys_spec" in vars(altair)
    assert altair.phase0 is tspec


@pytest.mark.parametrize("fork", ["merge", "sharding", "custody_game"])
def test_forks_without_sources_raise(fork):
    with pytest.raises(NotImplementedError, match="has no spec sources"):
        tbuilder.build_spec_module(fork, "minimal")
    with pytest.raises(ValueError, match="unknown fork"):
        tbuilder.build_spec_module("no_such_fork", "minimal")


def test_spec_targets_cover_the_implemented_forks():
    targets = tbuilder.spec_targets()
    assert sorted(targets) == ["mainnet", "minimal"]
    for preset, forks in targets.items():
        assert sorted(forks) == ["altair", "phase0"]
        assert forks["altair"].__name__ == \
            f"consensus_specs_tpu_torch.altair.{preset}"


def test_neither_package_sees_the_others_bls():
    """Both packages' specs in one process: the port's collector patches
    only the port spec and the port switchboard for its span, and the JAX
    spec keeps its own switchboard and flag throughout."""
    jspec, tspec = _specs("phase0")
    jfns = {n: getattr(jbls, n) for n in ("FastAggregateVerify", "Verify")}
    jbls.bls_active = False
    with tbv.SignatureCollector(tspec):
        assert tspec.bls is tbls and jspec.bls is jbls
        assert {n: getattr(jbls, n) for n in jfns} == jfns
        assert tbls.bls_active is True and jbls.bls_active is False
    assert tspec.bls is tbls and jspec.bls is jbls
    assert jbls.bls_active is False and tbls.bls_active is True
    # the port helpers' key derivation flips the port flag only, and
    # puts it back
    from consensus_specs_tpu_torch.test.helpers.keys import pubkeys

    tbls.bls_active = False
    assert len(pubkeys[3]) == 48
    assert tbls.bls_active is False and jbls.bls_active is False


def test_expect_assertion_error_restores_the_flag():
    from consensus_specs_tpu_torch.test.context import (
        ALTAIR, PHASE0, expect_assertion_error,
    )

    assert (PHASE0, ALTAIR) == ("phase0", "altair")

    def fails():
        tbls.bls_active = False
        raise AssertionError

    expect_assertion_error(fails)
    assert tbls.bls_active is True
    with pytest.raises(AssertionError, match="expected an assertion error"):
        expect_assertion_error(lambda: None)


# -- genesis and a replayed history -------------------------------------------


def _genesis(spec, helpers_genesis):
    return helpers_genesis.create_genesis_state(
        spec, [spec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
        spec.MAX_EFFECTIVE_BALANCE)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_genesis_roots_agree(fork):
    from consensus_specs_tpu.test.helpers import genesis as jgenesis
    from consensus_specs_tpu_torch.test.helpers import genesis as tgenesis

    jspec, tspec = _specs(fork)
    jstate, tstate = _genesis(jspec, jgenesis), _genesis(tspec, tgenesis)
    assert tstate.encode_bytes() == jstate.encode_bytes()
    assert bytes(tstate.hash_tree_root()) == bytes(jstate.hash_tree_root())


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_two_epoch_history_replays_to_the_jax_roots(fork):
    """Two epochs of blocks with every committee's attestation, built by
    the JAX helpers with BLS off, moved across by bytes and replayed
    through the port's spec: the JAX post-state root after every block."""
    from consensus_specs_tpu.test.helpers import genesis as jgenesis
    from consensus_specs_tpu.test.helpers.attestations import (
        next_slots_with_attestations,
    )

    jspec, tspec = _specs(fork)
    genesis = _genesis(jspec, jgenesis)
    jbls.bls_active = tbls.bls_active = False
    _, blocks, _ = next_slots_with_attestations(
        jspec, genesis, 2 * int(jspec.SLOTS_PER_EPOCH), True, False)
    assert sum(len(b.message.body.attestations) for b in blocks) > 0
    jstate = genesis.copy()
    tstate = tspec.BeaconState.decode_bytes(genesis.encode_bytes())
    for i, signed in enumerate(blocks):
        jspec.state_transition(jstate, signed)
        tspec.state_transition(
            tstate, tspec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
        assert bytes(tstate.hash_tree_root()) == \
            bytes(jstate.hash_tree_root()), (fork, i)
    assert int(tstate.slot) == 2 * int(tspec.SLOTS_PER_EPOCH)


# -- signature checks: the port's collector against the JAX collector ---------


def _signed_blocks(fork):
    """(pre-state, [signed blocks]) built with BLS on by the JAX helpers,
    all on one pre-state: phase0, a block with every committee's
    attestation of the slot before; altair, a block with a full 32-member
    sync aggregate and a copy with one bit cleared (signature kept)."""
    from consensus_specs_tpu.batch_verify import SignatureCollector
    from consensus_specs_tpu.test.helpers import genesis as jgenesis
    from consensus_specs_tpu.test.helpers.attestations import (
        get_valid_attestation,
    )
    from consensus_specs_tpu.test.helpers.block import (
        build_empty_block_for_next_slot, sign_block,
    )
    from consensus_specs_tpu.test.helpers.state import (
        next_slot, state_transition_and_sign_block,
    )
    from consensus_specs_tpu.test.helpers.sync_committee import (
        build_sync_aggregate,
    )

    jspec, _ = _specs(fork)
    state = _genesis(jspec, jgenesis)
    next_slot(jspec, state)
    block = build_empty_block_for_next_slot(jspec, state)
    if fork == "phase0":
        epoch = jspec.get_current_epoch(state)
        for index in range(int(jspec.get_committee_count_per_slot(state,
                                                                  epoch))):
            block.body.attestations.append(get_valid_attestation(
                jspec, state, slot=state.slot, index=index, signed=True))
    else:
        bits = [True] * int(jspec.SYNC_COMMITTEE_SIZE)
        block.body.sync_aggregate = build_sync_aggregate(
            jspec, state, bits, slot=block.slot)
    # sealed with the checks collected (no eager pairing while sealing)
    with SignatureCollector(jspec):
        blocks = [state_transition_and_sign_block(jspec, state.copy(),
                                                  block)]
        if fork == "altair":
            bad = block.copy()
            bad.body.sync_aggregate.sync_committee_bits[5] = False
            scratch = state.copy()
            jbls.bls_active = False
            jspec.process_slots(scratch, bad.slot)
            jspec.process_block(scratch, bad)
            bad.state_root = jspec.hash_tree_root(scratch)
            jbls.bls_active = True
            blocks.append(sign_block(jspec, state, bad))
    return state, blocks


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_collector_verdicts_equal_the_jax_collector(fork):
    from consensus_specs_tpu.batch_verify import SignatureCollector

    jspec, tspec = _specs(fork)
    pre, blocks = _signed_blocks(fork)
    with SignatureCollector(jspec) as jcol:
        for signed in blocks:
            jspec.state_transition(pre.copy(), signed)
    tpre = tspec.BeaconState.decode_bytes(pre.encode_bytes())
    with tbv.SignatureCollector(tspec) as tcol:
        for signed in blocks:
            tspec.state_transition(
                tpre.copy(),
                tspec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
    fields = lambda col: [(c.kind, c.pubkeys, c.messages, c.signature)  # noqa
                          for c in col.checks]
    assert fields(tcol) == fields(jcol)
    kinds = [(c.kind, len(c.pubkeys)) for c in tcol.checks]
    if fork == "altair":
        assert ("fast_aggregate", 32) in kinds
        assert ("fast_aggregate", 31) in kinds
    else:
        assert sum(k > 1 for _, k in kinds) >= 2
    want = jcol.flush_oracle()
    got = tcol.flush(device="cpu")
    assert np.array_equal(got, want)
    assert want.all() == (fork == "phase0")
    if fork == "altair":
        assert [bool(v) for v, (_, k) in zip(got, kinds) if k > 1] == \
            [True, False]
