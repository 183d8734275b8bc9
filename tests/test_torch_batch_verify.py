"""The port's collect-then-verify plane (consensus_specs_tpu_torch/
batch_verify.py) against the JAX package's (consensus_specs_tpu/
batch_verify.py), on one built spec.

Both collectors see the same state transitions and must record the same
checks, field for field (kind, pubkeys, messages, signature). The port's
``flush`` on ``device="cpu"`` (the plain VM steps), per item and through
RLC, must give the JAX collector's ``flush_oracle()`` verdicts. The port's
collector points ``spec.bls`` at the port's switchboard for its span
only: the spec's own ``bls``, its wrapped handlers and the ``bls_active``
flag come back on exit, an exception included, and the JAX switchboard
module is never touched. The JAX ``flush()`` is not run here: its counts
are pinned by tests/test_batch_verify.py.

The reference's four slow cases (real-block replay, corruption, fork
choice batched and streamed) have twins here that run on the card
(``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu.utils.bls12_381 import R
from consensus_specs_tpu_torch import batch_verify as tbv
from consensus_specs_tpu_torch.ops import bls_backend as tback
from consensus_specs_tpu_torch.utils import bls as tbls
from tests.torch_threads import one_thread

one_thread()

RNG = np.random.default_rng(20261017)


@pytest.fixture
def jbv():
    """The JAX package's collector module (imported here: its backend
    imports jax, which the card's twins below do without)."""
    from consensus_specs_tpu import batch_verify

    return batch_verify


@pytest.fixture(autouse=True)
def _switchboards():
    """BLS on in both switchboards, the port's eager Verify on the CPU
    oracle; everything restored after."""
    was = (jbls.bls_active, tbls.bls_active, tbls._backend)
    jbls.bls_active = tbls.bls_active = True
    tbls.use_py_ecc()
    yield
    jbls.bls_active, tbls.bls_active, tbls._backend = was


def _fields(col):
    return [(c.kind, c.pubkeys, c.messages, c.signature) for c in col.checks]


def _switchboard_functions(mod):
    return {n: getattr(mod, n) for n in ("FastAggregateVerify",
                                         "AggregateVerify", "Verify")}


def _spec_functions(spec):
    return {n: getattr(spec, n) for n in (
        "verify_block_signature", "process_randao",
        "process_voluntary_exit", "process_proposer_slashing")}


@pytest.fixture(scope="module")
def phase0():
    from consensus_specs_tpu.test.context import build_spec_module
    from consensus_specs_tpu.test.helpers.genesis import create_genesis_state

    spec = build_spec_module("phase0", "minimal")
    was = jbls.bls_active
    jbls.bls_active = True
    try:
        state = create_genesis_state(
            spec, [spec.MAX_EFFECTIVE_BALANCE] * 64,
            spec.MAX_EFFECTIVE_BALANCE)
    finally:
        jbls.bls_active = was
    return spec, state


@pytest.fixture(scope="module")
def exit_block(phase0):
    """(pre-state, signed block): a block carrying one voluntary exit, so
    a replay records the proposer, randao and exit signatures."""
    from consensus_specs_tpu.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu.test.helpers.state import (
        next_slot, state_transition_and_sign_block,
    )
    from consensus_specs_tpu.test.helpers.voluntary_exits import (
        prepare_signed_exits,
    )

    spec, genesis = phase0
    was = jbls.bls_active
    jbls.bls_active = True
    try:
        state = genesis.copy()
        state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH
        next_slot(spec, state)
        exits = prepare_signed_exits(spec, state, [60])
        block = build_empty_block_for_next_slot(spec, state)
        block.body.voluntary_exits = exits
        # sealed through a throwaway collector: no eager oracle pairing
        with tbv.SignatureCollector(spec):
            signed = state_transition_and_sign_block(spec, state.copy(),
                                                     block)
    finally:
        jbls.bls_active = was
    return state, signed


def _mk_check(cols, k, msg, corrupt=False):
    sks = [int(x) for x in RNG.integers(1, 1 << 62, size=k)]
    pks = [jbls.SkToPk(sk) for sk in sks]
    sig = jbls.Sign(sum(sks) % R, msg)
    if corrupt:
        msg = b"X" + msg[1:]
    for col in cols:
        col._fast_aggregate_verify(pks, msg, sig)


def test_collector_records_and_answers_true(jbv):
    jax_fns = _switchboard_functions(jbls)
    with jbv.SignatureCollector() as jcol:
        assert jbls.FastAggregateVerify([b"\x01" * 48], b"\x02" * 32,
                                        b"\x03" * 96)
        assert not jbls.FastAggregateVerify([], b"\x02" * 32, b"\x03" * 96)
        assert not jbls.AggregateVerify([b"\x01" * 48], [], b"\x03" * 96)
        assert jbls.AggregateVerify([b"\x01" * 48], [b"\x04" * 32],
                                    b"\x03" * 96)
    with tbv.SignatureCollector() as tcol:
        # the JAX switchboard stays as it was
        assert _switchboard_functions(jbls) == jax_fns
        assert tbls.FastAggregateVerify([b"\x01" * 48], b"\x02" * 32,
                                        b"\x03" * 96)
        assert not tbls.FastAggregateVerify([], b"\x02" * 32, b"\x03" * 96)
        assert not tbls.AggregateVerify([b"\x01" * 48], [], b"\x03" * 96)
        assert tbls.AggregateVerify([b"\x01" * 48], [b"\x04" * 32],
                                    b"\x03" * 96)
    assert tbls.FastAggregateVerify.__name__ != "_fast_aggregate_verify"
    assert _fields(tcol) == _fields(jcol)
    assert [c[0] for c in _fields(tcol)] == ["fast_aggregate", "aggregate"]


def test_flush_matches_oracle_small(jbv):
    jcol, tcol = jbv.SignatureCollector(), tbv.SignatureCollector()
    _mk_check((jcol, tcol), 2, b"m1" + b"\x00" * 30)
    _mk_check((jcol, tcol), 3, b"m2" + b"\x00" * 30)
    _mk_check((jcol, tcol), 2, b"m3" + b"\x00" * 30, corrupt=True)
    assert _fields(tcol) == _fields(jcol)
    want = jcol.flush_oracle()
    assert list(want) == [True, True, False]
    assert np.array_equal(tcol.flush_oracle(), want)
    assert np.array_equal(tcol.flush(device="cpu"), want)
    assert np.array_equal(tcol.flush(device="cpu", rlc=True), want)


def test_flush_dedups_identical_checks(jbv):
    """The same attestation in several blocks is ONE backend verification,
    fanned out to every occurrence."""
    jcol, tcol = jbv.SignatureCollector(), tbv.SignatureCollector()
    _mk_check((jcol, tcol), 2, b"d1" + b"\x00" * 30)
    tcol.checks.append(tcol.checks[-1])
    jcol.checks.append(jcol.checks[-1])
    _mk_check((jcol, tcol), 2, b"d2" + b"\x00" * 30, corrupt=True)
    tcol.checks.append(tcol.checks[-1])
    jcol.checks.append(jcol.checks[-1])
    assert _fields(tcol) == _fields(jcol)
    before = tback.CALL_COUNTS["items"]
    got = tcol.flush(device="cpu")
    assert tback.CALL_COUNTS["items"] - before == 2  # 4 records, 2 uniques
    want = jcol.flush_oracle()
    assert np.array_equal(got, want)
    assert list(want) == [True, True, False, False]


def test_flush_refuses_mixed_routes():
    col = tbv.SignatureCollector()
    with pytest.raises(ValueError, match="backend/device"):
        col.flush(device="cpu", service=object())
    with pytest.raises(ValueError, match="rlc=True"):
        col.flush(service=object(), rlc=True)


def test_randao_and_exit_checks_ride_the_deferred_plane(jbv, phase0,
                                                      exit_block):
    spec, _ = phase0
    pre, signed = exit_block
    jax_fns = _switchboard_functions(jbls)
    jstate, tstate = pre.copy(), pre.copy()
    with jbv.SignatureCollector(spec) as jcol:
        spec.state_transition(jstate, signed)
    with tbv.SignatureCollector(spec) as tcol:
        assert spec.bls is tbls
        assert _switchboard_functions(jbls) == jax_fns
        spec.state_transition(tstate, signed)
    assert spec.bls is jbls
    # proposer signature + randao reveal + the exit signature
    assert len(tcol.checks) == 3
    assert _fields(tcol) == _fields(jcol)
    assert spec.hash_tree_root(tstate) == spec.hash_tree_root(jstate)
    assert tstate.validators[60].exit_epoch != spec.FAR_FUTURE_EPOCH
    want = jcol.flush_oracle()
    assert want.all()
    assert np.array_equal(tcol.flush(device="cpu"), want)


def test_corrupt_randao_caught_at_flush_not_collection(jbv, phase0):
    from consensus_specs_tpu.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu.test.helpers.state import (
        state_transition_and_sign_block,
    )

    spec, genesis = phase0
    state = genesis.copy()
    block = build_empty_block_for_next_slot(spec, state)
    # a valid-encoding G2 point that is NOT the proposer's reveal, sealed
    # through a throwaway port collector (the eager path would refuse it)
    block.body.randao_reveal = jbls.Sign(12345, b"\x13" * 32)
    with tbv.SignatureCollector(spec):
        signed = state_transition_and_sign_block(spec, state.copy(), block)
    with jbv.SignatureCollector(spec) as jcol:
        spec.state_transition(state.copy(), signed)
    with tbv.SignatureCollector(spec) as tcol:
        spec.state_transition(state, signed)  # collection never raises
    assert _fields(tcol) == _fields(jcol)
    want = jcol.flush_oracle()
    assert list(want) == [True, False]  # proposer, randao
    assert np.array_equal(tcol.flush(device="cpu", rlc=True), want)
    assert tbls.Verify.__name__ != "_verify"


def test_deposit_verify_stays_eager_inside_collector(jbv, phase0):
    """An invalid deposit proof-of-possession is decided DURING collection
    (validator skipped, deposit absorbed), by the port's switchboard."""
    from consensus_specs_tpu.test.helpers.deposits import (
        prepare_state_and_deposit,
    )

    spec, genesis = phase0
    results = []
    for collector in (jbv.SignatureCollector, tbv.SignatureCollector):
        state = genesis.copy()
        n_before = len(state.validators)
        deposit = prepare_state_and_deposit(
            spec, state, n_before, spec.MAX_EFFECTIVE_BALANCE, signed=False)
        index_before = int(state.eth1_deposit_index)
        with collector(spec) as col:
            spec.process_deposit(state, deposit)
        assert len(col.checks) == 0
        assert len(state.validators) == n_before
        assert int(state.eth1_deposit_index) == index_before + 1
        results.append(spec.hash_tree_root(state))
    assert results[0] == results[1]


def test_altair_sync_aggregate_is_recorded(jbv, phase0):
    """eth_fast_aggregate_verify of an altair block's sync aggregate rides
    the deferred plane as one fast_aggregate check over the committee."""
    from consensus_specs_tpu.test.context import build_spec_module
    from consensus_specs_tpu.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu.test.helpers.genesis import create_genesis_state
    from consensus_specs_tpu.test.helpers.state import (
        state_transition_and_sign_block, transition_to,
    )
    from consensus_specs_tpu.test.helpers.sync_committee import (
        build_sync_aggregate,
    )

    spec = build_spec_module("altair", "minimal")
    state = create_genesis_state(spec, [spec.MAX_EFFECTIVE_BALANCE] * 64,
                                 spec.MAX_EFFECTIVE_BALANCE)
    transition_to(spec, state, state.slot + 3)
    block = build_empty_block_for_next_slot(spec, state)
    block.body.sync_aggregate = build_sync_aggregate(
        spec, state, [True] * int(spec.SYNC_COMMITTEE_SIZE), slot=block.slot)
    with jbv.SignatureCollector(spec):
        signed = state_transition_and_sign_block(spec, state.copy(), block)
    jstate, tstate = state.copy(), state.copy()
    with jbv.SignatureCollector(spec) as jcol:
        spec.state_transition(jstate, signed)
    with tbv.SignatureCollector(spec) as tcol:
        spec.state_transition(tstate, signed)
    assert spec.bls is jbls
    assert _fields(tcol) == _fields(jcol)
    assert spec.hash_tree_root(tstate) == spec.hash_tree_root(jstate)
    widths = sorted(len(c.pubkeys) for c in tcol.checks)
    assert widths == [1, 1, int(spec.SYNC_COMMITTEE_SIZE)]
    want = jcol.flush_oracle()
    assert want.all()
    assert np.array_equal(tcol.flush(device="cpu", rlc=True), want)


def test_nested_collectors(jbv, phase0, exit_block):
    spec, _ = phase0
    pre, signed = exit_block
    jax_fns = _switchboard_functions(jbls)
    port_fns = _switchboard_functions(tbls)
    spec_fns = _spec_functions(spec)
    with tbv.SignatureCollector(spec) as single:
        spec.state_transition(pre.copy(), signed)

    # a JAX collector inside a port one: the JAX collector wraps the
    # proposer check last, so it records it; bls.* now resolves to the
    # port's switchboard, so the port collector records the rest
    with tbv.SignatureCollector(spec) as outer:
        with jbv.SignatureCollector(spec) as inner:
            assert spec.bls is tbls
            spec.state_transition(pre.copy(), signed)
        assert spec.bls is tbls
        assert _switchboard_functions(jbls) == jax_fns
    assert _fields(inner) == _fields(single)[:1]
    assert _fields(outer) == _fields(single)[1:]

    # a port collector inside another: the inner records everything, and
    # the outer's interceptors are back when it exits
    with tbv.SignatureCollector(spec) as outer:
        outer_fns = _switchboard_functions(tbls)
        with tbv.SignatureCollector(spec) as inner:
            spec.state_transition(pre.copy(), signed)
        assert _switchboard_functions(tbls) == outer_fns
        assert spec.bls is tbls
    assert _fields(inner) == _fields(single)
    assert outer.checks == []

    assert spec.bls is jbls
    assert _switchboard_functions(jbls) == jax_fns
    assert _switchboard_functions(tbls) == port_fns
    assert _spec_functions(spec) == spec_fns


def test_exception_restores_spec_bls_and_flag(phase0, exit_block):
    spec, _ = phase0
    pre, signed = exit_block
    port_fns = _switchboard_functions(tbls)
    spec_fns = _spec_functions(spec)
    jbls.bls_active = False  # the spec's own switchboard is in stub mode
    with pytest.raises(RuntimeError, match="boom"):
        with tbv.SignatureCollector(spec) as col:
            # the stub flag crossed over: nothing is recorded
            assert tbls.bls_active is False
            spec.state_transition(pre.copy(), signed)
            raise RuntimeError("boom")
    assert col.checks == []
    assert spec.bls is jbls
    assert jbls.bls_active is False
    assert tbls.bls_active is True
    assert _switchboard_functions(tbls) == port_fns
    assert _spec_functions(spec) == spec_fns


# ---------------------------------------------------------------------------
# twins of the reference's slow cases, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: flush runs on the card")
    pytest.importorskip("yaml")  # the JAX builder reads its presets with it


def _replay_world(spec):
    from consensus_specs_tpu.test.helpers.attestations import (
        next_slots_with_attestations,
    )
    from consensus_specs_tpu.test.helpers.genesis import create_genesis_state
    from consensus_specs_tpu.test.helpers.state import next_epoch

    state = create_genesis_state(spec, [spec.MAX_EFFECTIVE_BALANCE] * 64,
                                 spec.MAX_EFFECTIVE_BALANCE)
    next_epoch(spec, state)
    base = state.copy()
    _, signed_blocks, post = next_slots_with_attestations(
        spec, state, 2, True, False)
    return base, signed_blocks, post


@pytest.mark.cuda
def test_epoch_replay_batched_matches_sequential_on_card(card, phase0):
    spec, _ = phase0
    base, signed_blocks, post_sequential = _replay_world(spec)
    replay_state = base.copy()
    ok = tbv.replay_blocks_batched(spec, replay_state, signed_blocks)
    assert ok.all()
    assert len(ok) >= len(signed_blocks)
    assert spec.hash_tree_root(replay_state) == spec.hash_tree_root(
        post_sequential)
    assert spec.bls is jbls


@pytest.mark.cuda
def test_epoch_replay_detects_corruption_on_card(card, phase0):
    from consensus_specs_tpu.test.helpers.block import sign_block

    spec, _ = phase0
    base, signed_blocks, _ = _replay_world(spec)
    bad = signed_blocks[-1].message.copy()
    assert len(bad.body.attestations) > 0
    bad.body.attestations[0].signature = spec.BLSSignature(
        b"\xaa" + b"\x00" * 95)
    scratch = base.copy()
    jbls.bls_active = False
    for sb in signed_blocks[:-1]:
        spec.state_transition(scratch, sb)
    bad.state_root = spec.compute_new_state_root(scratch, bad)
    jbls.bls_active = True
    resigned = sign_block(spec, scratch, bad)
    blocks = list(signed_blocks[:-1]) + [resigned]

    ok = tbv.replay_blocks_batched(spec, base.copy(), blocks)
    assert not ok.all()
    # the same checks re-resolved sequentially by the oracle, and through
    # RLC on the card: identical verdicts
    with tbv.SignatureCollector(spec) as col:
        state2 = base.copy()
        for sb in blocks:
            spec.state_transition(state2, sb)
    assert np.array_equal(ok, col.flush_oracle())
    assert np.array_equal(col.flush(rlc=True), ok)


def _fork_choice_world(spec):
    from consensus_specs_tpu.test.helpers.attestations import (
        get_valid_attestation,
    )
    from consensus_specs_tpu.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu.test.helpers.fork_choice import (
        get_genesis_forkchoice_store, slot_time,
    )
    from consensus_specs_tpu.test.helpers.genesis import create_genesis_state
    from consensus_specs_tpu.test.helpers.state import (
        state_transition_and_sign_block,
    )

    state = create_genesis_state(spec, [spec.MAX_EFFECTIVE_BALANCE] * 64,
                                 spec.MAX_EFFECTIVE_BALANCE)
    store = get_genesis_forkchoice_store(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    spec.on_tick(store, slot_time(spec, store, block.slot + 1))
    spec.on_block(store, signed_block)
    attestations = [
        get_valid_attestation(spec, state, slot=block.slot, index=i,
                              signed=True)
        for i in range(int(spec.get_committee_count_per_slot(
            state, spec.get_current_epoch(state))))
    ]
    voters = set()
    for a in attestations:
        voters |= set(spec.get_attesting_indices(state, a.data,
                                                 a.aggregation_bits))
    return store, attestations, voters


@pytest.mark.cuda
def test_fork_choice_attestations_batched_on_card(card, phase0):
    spec, _ = phase0
    store, attestations, voters = _fork_choice_world(spec)
    ok = tbv.feed_attestations_batched(spec, store, attestations)
    assert len(ok) == len(attestations) and ok.all()
    assert set(store.latest_messages) == voters


@pytest.mark.cuda
def test_fork_choice_attestations_streamed_on_card(card, phase0):
    from consensus_specs_tpu_torch.serve import VerificationService

    spec, _ = phase0
    store, attestations, voters = _fork_choice_world(spec)
    stream = attestations + attestations  # every copy heard from two peers
    tback.reset_call_counts()
    svc = VerificationService()
    try:
        ok = tbv.feed_attestations_streamed(spec, store, iter(stream),
                                            service=svc)
    finally:
        svc.close(timeout=60)
    assert len(ok) == len(stream) and ok.all()
    assert tback.CALL_COUNTS["items"] == len(attestations)
    assert set(store.latest_messages) == voters
    # and with a private service of its own
    store2, _, _ = _fork_choice_world(spec)
    ok2 = tbv.feed_attestations_streamed(spec, store2, iter(attestations))
    assert ok2.all() and set(store2.latest_messages) == voters
