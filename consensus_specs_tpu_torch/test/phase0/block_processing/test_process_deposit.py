"""process_deposit handler tests
(reference: test/phase0/block_processing/test_process_deposit.py).

Provenance: adapted from the reference's test/phase0/block_processing/test_process_deposit.py — scenario code and comments largely follow the reference test suite; newer suites in this repo are original.
"""
from ...context import (
    always_bls, spec_state_test, with_all_phases,
)
from ...helpers.deposits import (
    build_deposit, build_deposit_tree_and_root, prepare_state_and_deposit,
    run_deposit_processing, sign_deposit_data,
)
from ...helpers.keys import privkeys, pubkeys


@with_all_phases
@spec_state_test
def test_new_deposit_under_max(spec, state):
    # fresh deposit = next validator index = validator appended to registry
    validator_index = len(state.validators)
    # effective balance will be 1 EFFECTIVE_BALANCE_INCREMENT smaller because of this small decrement.
    amount = spec.MAX_EFFECTIVE_BALANCE - 1
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=True)

    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
def test_new_deposit_max(spec, state):
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=True)

    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
def test_new_deposit_over_max(spec, state):
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE + 1
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=True)

    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
@always_bls
def test_new_deposit_eth1_withdrawal_credentials(spec, state):
    validator_index = len(state.validators)
    withdrawal_credentials = (
        spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX
        + b'\x00' * 11  # specified 0s
        + b'\x59' * 20  # a 20-byte eth1 address
    )
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(
        spec, state, validator_index, amount,
        withdrawal_credentials=withdrawal_credentials,
        signed=True,
    )

    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_new_deposit(spec, state):
    # fresh deposit = next validator index = validator appended to registry
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount)
    yield from run_deposit_processing(spec, state, deposit, validator_index, effective=False)


@with_all_phases
@spec_state_test
def test_success_top_up(spec, state):
    validator_index = 0
    amount = spec.MAX_EFFECTIVE_BALANCE // 4
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=True)

    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_top_up(spec, state):
    validator_index = 0
    amount = spec.MAX_EFFECTIVE_BALANCE // 4
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount)

    # invalid signatures, in top-ups, are allowed!
    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
def test_invalid_withdrawal_credentials_top_up(spec, state):
    validator_index = 0
    amount = spec.MAX_EFFECTIVE_BALANCE // 4
    withdrawal_credentials = spec.BLS_WITHDRAWAL_PREFIX + spec.hash(b"junk")[1:]
    deposit = prepare_state_and_deposit(
        spec, state, validator_index, amount,
        withdrawal_credentials=withdrawal_credentials
    )

    # inconsistent withdrawal credentials, in top-ups, are allowed!
    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
def test_wrong_deposit_for_deposit_count(spec, state):
    deposit_data_leaves = []

    # build root for deposit_1
    index_1 = len(deposit_data_leaves)
    pubkey_1 = pubkeys[index_1]
    privkey_1 = privkeys[index_1]
    _, _, deposit_data_leaves = build_deposit(
        spec,
        deposit_data_leaves,
        pubkey_1,
        privkey_1,
        spec.MAX_EFFECTIVE_BALANCE,
        withdrawal_credentials=b'\x00' * 32,
        signed=True,
    )
    deposit_count_1 = len(deposit_data_leaves)

    # build root for deposit_2
    index_2 = len(deposit_data_leaves)
    pubkey_2 = pubkeys[index_2]
    privkey_2 = privkeys[index_2]
    deposit_2, root_2, deposit_data_leaves = build_deposit(
        spec,
        deposit_data_leaves,
        pubkey_2,
        privkey_2,
        spec.MAX_EFFECTIVE_BALANCE,
        withdrawal_credentials=b'\x00' * 32,
        signed=True,
    )

    # state has root for deposit_2 but is at deposit_count for deposit_1
    state.eth1_data.deposit_root = root_2
    state.eth1_data.deposit_count = deposit_count_1
    state.eth1_deposit_index = 0

    yield from run_deposit_processing(spec, state, deposit_2, index_2, valid=False)


@with_all_phases
@spec_state_test
def test_bad_merkle_proof(spec, state):
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount)

    # mess up merkle branch
    deposit.proof[5] = spec.Bytes32()

    sign_deposit_data(spec, deposit.data, privkeys[validator_index])

    yield from run_deposit_processing(spec, state, deposit, validator_index, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_key_validate_invalid_subgroup(spec, state):
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE

    # All-zero pubkey is an invalid encoding (not on curve)
    pubkey = spec.BLSPubkey(b'\x00' * 48)

    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=True)
    deposit.data.pubkey = pubkey
    # proof now invalid for modified data; rebuild
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount)
    deposit.data.pubkey = pubkey
    from ...helpers.deposits import build_deposit_tree_and_root, deposit_from_context

    deposit, root, _ = deposit_from_context(spec, [deposit.data], 0)
    state.eth1_deposit_index = 0
    state.eth1_data.deposit_root = root
    state.eth1_data.deposit_count = 1

    yield from run_deposit_processing(spec, state, deposit, validator_index, effective=False)


@with_all_phases
@spec_state_test
def test_new_deposit_non_versioned_withdrawal_credentials(spec, state):
    # any credential prefix is accepted at deposit time — versioning is a
    # withdrawal-time concern
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(
        spec, state, validator_index, amount, signed=True,
        withdrawal_credentials=b'\xff' + b'\x02' * 31,
    )
    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_other_fork_version(spec, state):
    # deposits always verify under GENESIS_FORK_VERSION: a signature
    # computed with another version must be treated as an invalid proof of
    # possession (deposit still absorbed with no validator created)
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=False)

    domain = spec.compute_domain(
        spec.DOMAIN_DEPOSIT, fork_version=spec.Version(b'\x09\x09\x09\x09')
    )
    signing_root = spec.compute_signing_root(
        spec.DepositMessage(
            pubkey=deposit.data.pubkey,
            withdrawal_credentials=deposit.data.withdrawal_credentials,
            amount=deposit.data.amount,
        ),
        domain,
    )
    deposit.data.signature = spec.bls.Sign(privkeys[validator_index], signing_root)
    # re-anchor the deposit root to the mutated data
    _, state.eth1_data.deposit_root = build_deposit_tree_and_root(spec, [deposit.data])

    yield from run_deposit_processing(
        spec, state, deposit, validator_index, effective=False
    )


@with_all_phases
@spec_state_test
@always_bls
def test_valid_sig_but_forked_state(spec, state):
    # deposits pin GENESIS_FORK_VERSION in their signing domain: a state
    # whose fork has moved on must STILL accept a genesis-version signature
    # (compute_domain with no fork_version default, reference
    # specs/phase0/beacon-chain.md:1871-1887)
    state.fork.current_version = spec.Version(b'\x07\x07\x07\x07')
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(
        spec, state, validator_index, amount, signed=True
    )
    yield from run_deposit_processing(spec, state, deposit, validator_index)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_current_version_on_forked_state(spec, state):
    # the converse: signing under the state's CURRENT (non-genesis) version
    # is an invalid proof of possession even though the state carries that
    # very version
    state.fork.current_version = spec.Version(b'\x07\x07\x07\x07')
    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=False)
    domain = spec.compute_domain(
        spec.DOMAIN_DEPOSIT, fork_version=state.fork.current_version
    )
    signing_root = spec.compute_signing_root(
        spec.DepositMessage(
            pubkey=deposit.data.pubkey,
            withdrawal_credentials=deposit.data.withdrawal_credentials,
            amount=deposit.data.amount,
        ),
        domain,
    )
    deposit.data.signature = spec.bls.Sign(privkeys[validator_index], signing_root)
    _, state.eth1_data.deposit_root = build_deposit_tree_and_root(spec, [deposit.data])
    yield from run_deposit_processing(
        spec, state, deposit, validator_index, effective=False
    )
