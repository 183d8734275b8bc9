"""The port's executable spec (consensus_specs_tpu_torch/builder.py,
config/, specsrc/ for all five forks and the test/helpers subset) against
the JAX package's, on the CPU.

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
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "presets", "*", "*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "*.yaml")))
FORKS = ["phase0", "altair", "merge", "sharding", "custody_game"]
NEW_FORKS = FORKS[2:]
BUILDS = [(f, p) for f in FORKS for p in ("minimal", "mainnet")]
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


@pytest.mark.parametrize("fork,preset", BUILDS)
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
for fork in builder.IMPLEMENTED_FORKS:
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
    assert got["consensus_specs_tpu_torch.custody_game.mainnet"] == 32
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
    assert tbuilder.IMPLEMENTED_FORKS == FORKS
    assert tbuilder.FORK_ORDER == jbuilder.FORK_ORDER
    # the optimizations the JAX builder applies
    assert hasattr(tspec.compute_shuffled_index, "__wrapped_raw__")
    assert tspec.compute_shuffled_index(5, 64, b"\x07" * 32) == \
        jspec.compute_shuffled_index(5, 64, b"\x07" * 32)
    altair = tbuilder.build_spec_module("altair", "minimal")
    assert "_eth_aggregate_pubkeys_spec" in vars(altair)
    assert altair.phase0 is tspec


def test_unknown_fork_raises():
    with pytest.raises(ValueError, match="unknown fork"):
        tbuilder.build_spec_module("no_such_fork", "minimal")


@pytest.mark.parametrize("fork", NEW_FORKS)
def test_new_fork_layers_on_the_port_modules(fork):
    """Each draft-era fork builds on the port's own earlier forks, with the
    port's switchboard; sharding's KZG setup is the port's lazy setup (its
    own per-(tau, n) cache), never the JAX package's."""
    from consensus_specs_tpu.utils import kzg as jkzg
    from consensus_specs_tpu_torch.utils import kzg as tkzg

    jspec, tspec = _specs(fork)
    lineage = FORKS[:FORKS.index(fork)]
    assert [getattr(tspec, f).__name__ for f in lineage] == \
        [f"consensus_specs_tpu_torch.{f}.minimal" for f in lineage]
    assert tspec.bls is tbls and tspec.fork == fork
    if fork != "merge":
        assert tspec.KZG_SETUP is tkzg.lazy_setup(int(tspec.KZG_SETUP_TAU),
                                                  int(tspec.KZG_SETUP_SIZE))
        assert tspec.KZG_SETUP is not jspec.KZG_SETUP
        assert jspec.KZG_SETUP is jkzg.lazy_setup(int(jspec.KZG_SETUP_TAU),
                                                  int(jspec.KZG_SETUP_SIZE))
        assert bytes(tspec.G1_SETUP[1]) == bytes(jspec.G1_SETUP[1])
        assert bytes(tspec.G2_SETUP[-8]) == bytes(jspec.G2_SETUP[-8])
        assert tspec._kzg.__name__ == "consensus_specs_tpu_torch.utils.kzg"


def test_spec_targets_cover_the_implemented_forks():
    targets = tbuilder.spec_targets()
    assert sorted(targets) == ["mainnet", "minimal"]
    for preset, forks in targets.items():
        assert sorted(forks) == sorted(FORKS)
        for fork in FORKS:
            assert forks[fork].__name__ == \
                f"consensus_specs_tpu_torch.{fork}.{preset}"


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


@pytest.mark.parametrize("fork", FORKS)
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


def _fork_block(fork, jspec, state):
    """A block of a draft-era fork for the slot after ``state``, built by
    the JAX helpers (BLS as the caller set it): merge, with an execution
    payload on a merge-complete state; sharding, with a shard header for
    the slot before; custody_game, with a custody key reveal (a validator
    whose first custody period has ended) and an early derived secret
    reveal. ``state`` must come from _fork_pre_state."""
    from consensus_specs_tpu.test.helpers.block import (
        build_empty_block_for_next_slot,
    )

    block = build_empty_block_for_next_slot(jspec, state)
    if fork == "merge":
        from consensus_specs_tpu.test.helpers.execution_payload import (
            build_empty_execution_payload,
        )

        at = state.copy()
        jspec.process_slots(at, block.slot)
        block.body.execution_payload = build_empty_execution_payload(jspec, at)
    elif fork == "sharding":
        from consensus_specs_tpu.test.helpers.shard_blob import (
            build_shard_blob_header,
        )

        block.body.shard_headers.append(build_shard_blob_header(
            jspec, state, slot=state.slot - 1, shard=0))
    else:
        from consensus_specs_tpu.test.helpers.custody_game import (
            get_valid_custody_key_reveal,
            get_valid_early_derived_secret_reveal,
        )

        block.body.custody_key_reveals.append(get_valid_custody_key_reveal(
            jspec, state, validator_index=CUSTODY_REVEALER))
        block.body.early_derived_secret_reveals.append(
            get_valid_early_derived_secret_reveal(jspec, state))
    return block


# the custody key revealer: the draft's exit-period test evaluates
# get_custody_period_for_validator(i, FAR_FUTURE_EPOCH - 1), which fits a
# uint64 only for i % EPOCHS_PER_CUSTODY_PERIOD in (0, 1); validator 1's
# first period ends at epoch EPOCHS_PER_CUSTODY_PERIOD - 1
CUSTODY_REVEALER = 1


def _fork_pre_state(fork, jspec):
    """The JAX helpers' genesis for ``fork``; merge made merge-complete,
    sharding one epoch and a slot on (armed shard work), custody_game a
    slot into the epoch where CUSTODY_REVEALER's first period has ended
    (empty slots, as the JAX package's custody sanity test walks)."""
    from consensus_specs_tpu.test.helpers import genesis as jgenesis
    from consensus_specs_tpu.test.helpers.execution_payload import (
        build_state_with_complete_transition,
    )
    from consensus_specs_tpu.test.helpers.state import (
        next_epoch, next_slot, transition_to,
    )

    state = _genesis(jspec, jgenesis)
    if fork == "merge":
        build_state_with_complete_transition(jspec, state)
    elif fork == "sharding":
        next_epoch(jspec, state)
        next_slot(jspec, state)
    else:
        epoch = int(jspec.EPOCHS_PER_CUSTODY_PERIOD) - CUSTODY_REVEALER
        transition_to(jspec, state, epoch * int(jspec.SLOTS_PER_EPOCH) + 1)
    return state


@pytest.mark.parametrize("fork", NEW_FORKS)
def test_new_fork_block_replays_to_the_jax_root(fork):
    """A block of each draft-era fork, built by the JAX helpers with BLS
    off, moved across by bytes: the same post-state root on both
    packages, and the operation took effect."""
    from consensus_specs_tpu.test.helpers.state import (
        state_transition_and_sign_block,
    )

    jspec, tspec = _specs(fork)
    jbls.bls_active = tbls.bls_active = False
    pre = _fork_pre_state(fork, jspec)
    jstate = pre.copy()
    signed = state_transition_and_sign_block(
        jspec, jstate, _fork_block(fork, jspec, pre))
    tstate = tspec.BeaconState.decode_bytes(pre.encode_bytes())
    tspec.state_transition(
        tstate, tspec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
    assert tstate.encode_bytes() == jstate.encode_bytes()
    assert bytes(tstate.hash_tree_root()) == bytes(jstate.hash_tree_root())
    body = signed.message.body
    if fork == "merge":
        assert tstate.latest_execution_payload_header.block_hash == \
            body.execution_payload.block_hash
    elif fork == "sharding":
        header = body.shard_headers[0].message
        work = tstate.shard_buffer[
            int(header.slot) % int(tspec.SHARD_STATE_MEMORY_SLOTS)][0]
        # after the empty "confirm nothing" entry the epoch armed
        assert len(work.status.value) == 2
        assert bytes(work.status.value[-1].attested.root) == \
            bytes(header.hash_tree_root())
    else:
        reveal = body.custody_key_reveals[0]
        assert tstate.validators[reveal.revealer_index] \
            .next_custody_secret_to_reveal == 1
        assert tstate.validators[
            body.early_derived_secret_reveals[0].revealed_index].slashed


def test_new_fork_helpers_build_the_jax_bytes():
    """The port's copies of the draft-era helpers (execution payload, shard
    blob, custody game) build byte-identical objects from equal states."""
    from consensus_specs_tpu.test.helpers import custody_game as jcg
    from consensus_specs_tpu.test.helpers import execution_payload as jep
    from consensus_specs_tpu.test.helpers import shard_blob as jsb
    from consensus_specs_tpu_torch.test.helpers import custody_game as tcg
    from consensus_specs_tpu_torch.test.helpers import execution_payload as tep
    from consensus_specs_tpu_torch.test.helpers import fork_transition as tft
    from consensus_specs_tpu_torch.test.helpers import shard_blob as tsb

    assert tft.UPGRADE_FN_BY_FORK == {"altair": "upgrade_to_altair",
                                      "merge": "upgrade_to_merge"}
    jbls.bls_active = tbls.bls_active = False
    jspec, tspec = _specs("merge")
    jstate = _fork_pre_state("merge", jspec)
    tstate = tspec.BeaconState.decode_bytes(jstate.encode_bytes())
    assert tep.build_empty_execution_payload(tspec, tstate).encode_bytes() == \
        jep.build_empty_execution_payload(jspec, jstate).encode_bytes()
    for fork in ("sharding", "custody_game"):
        jspec, tspec = _specs(fork)
        jstate = _fork_pre_state(fork, jspec)
        tstate = tspec.BeaconState.decode_bytes(jstate.encode_bytes())
        slot = jstate.slot - 1
        assert tsb.build_shard_blob_header(
            tspec, tstate, slot=slot, signed=False).encode_bytes() == \
            jsb.build_shard_blob_header(jspec, jstate, slot=slot,
                                        signed=False).encode_bytes()
        assert tsb.build_shard_proposer_slashing(
            tspec, tstate, signed=False).encode_bytes() == \
            jsb.build_shard_proposer_slashing(jspec, jstate,
                                              signed=False).encode_bytes()
    data = tcg.get_sample_custody_data(tspec, 3)
    assert data == jcg.get_sample_custody_data(jspec, 3)
    assert tcg.get_shard_blob_header_for_data(
        tspec, tstate, data, slot=slot).encode_bytes() == \
        jcg.get_shard_blob_header_for_data(jspec, jstate, data,
                                           slot=slot).encode_bytes()
    assert tcg.get_custody_chunk_branch(tspec, data, 1) == \
        jcg.get_custody_chunk_branch(jspec, data, 1)


# -- signature checks: the port's collector against the JAX collector ---------


def _planted_twin(fork, jspec, state, block):
    """A copy of ``block`` with one check planted false: altair, a sync
    bit cleared (signature kept); sharding, the shard header carrying
    another header's signature; custody_game, the early derived secret
    reveal carrying a signature over another message (the collectors defer
    its AggregateVerify; the key reveal's Verify stays eager in both)."""
    from consensus_specs_tpu.test.helpers.keys import privkeys

    bad = block.copy()
    if fork == "altair":
        bad.body.sync_aggregate.sync_committee_bits[5] = False
    elif fork == "sharding":
        from consensus_specs_tpu.test.helpers.shard_blob import (
            build_shard_blob_header,
        )

        other = build_shard_blob_header(jspec, state, slot=state.slot - 1,
                                        shard=0, data_seed=8)
        bad.body.shard_headers[0].signature = other.signature
    else:
        reveal = bad.body.early_derived_secret_reveals[0]
        reveal.reveal = jbls.Sign(privkeys[int(reveal.revealed_index)],
                                  b"\x5a" * 32)
    return bad


def _signed_blocks(fork):
    """(pre-state, [signed blocks]) built with BLS on by the JAX helpers,
    all on one pre-state: phase0, a block with every committee's
    attestation of the slot before; altair, a block with a full 32-member
    sync aggregate; sharding and custody_game, _fork_block's block; each
    of the last three with its _planted_twin."""
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
    if fork in NEW_FORKS:
        state = _fork_pre_state(fork, jspec)
        block = _fork_block(fork, jspec, state)
    else:
        state = _genesis(jspec, jgenesis)
        next_slot(jspec, state)
        block = build_empty_block_for_next_slot(jspec, state)
    if fork == "phase0":
        epoch = jspec.get_current_epoch(state)
        for index in range(int(jspec.get_committee_count_per_slot(state,
                                                                  epoch))):
            block.body.attestations.append(get_valid_attestation(
                jspec, state, slot=state.slot, index=index, signed=True))
    elif fork == "altair":
        bits = [True] * int(jspec.SYNC_COMMITTEE_SIZE)
        block.body.sync_aggregate = build_sync_aggregate(
            jspec, state, bits, slot=block.slot)
    # sealed with the checks collected (no eager pairing while sealing)
    with SignatureCollector(jspec):
        blocks = [state_transition_and_sign_block(jspec, state.copy(),
                                                  block)]
        if fork != "phase0":
            bad = _planted_twin(fork, jspec, state, block)
            scratch = state.copy()
            jbls.bls_active = False
            jspec.process_slots(scratch, bad.slot)
            jspec.process_block(scratch, bad)
            bad.state_root = jspec.hash_tree_root(scratch)
            jbls.bls_active = True
            blocks.append(sign_block(jspec, state, bad))
    return state, blocks


@pytest.mark.parametrize("fork", ["phase0", "altair", "sharding",
                                  "custody_game"])
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
    flagged = [kinds[i] for i in np.flatnonzero(~got)]
    if fork == "sharding":
        # the header's FastAggregateVerify over [builder, proposer]
        assert kinds.count(("fast_aggregate", 2)) == 2
        assert flagged == [("fast_aggregate", 2)]
    elif fork == "custody_game":
        # the early derived secret reveal's AggregateVerify, one a block
        assert kinds.count(("aggregate", 2)) == 2
        assert flagged == [("aggregate", 2)]
