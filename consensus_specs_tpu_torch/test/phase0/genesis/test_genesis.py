"""Genesis initialization + validity tests
(reference: test/phase0/genesis/test_initialization.py, test_validity.py)."""
from ...context import (
    MINIMAL, PHASE0, spec_test, with_phases, with_presets,
)
from ...helpers.deposits import build_deposit
from ...helpers.keys import privkeys, pubkeys


def create_valid_beacon_state(spec):
    deposit_count = spec.config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
    deposits, _, _ = prepare_full_genesis_deposits(
        spec, spec.MAX_EFFECTIVE_BALANCE, deposit_count, signed=True
    )

    eth1_block_hash = b'\x12' * 32
    eth1_timestamp = spec.config.MIN_GENESIS_TIME
    return spec.initialize_beacon_state_from_eth1(eth1_block_hash, eth1_timestamp, deposits)


def prepare_full_genesis_deposits(spec, amount, deposit_count, min_pubkey_index=0, signed=False,
                                  deposit_data_list=None):
    if deposit_data_list is None:
        deposit_data_list = []
    genesis_deposits = []
    for pubkey_index in range(min_pubkey_index, min_pubkey_index + deposit_count):
        pubkey = pubkeys[pubkey_index]
        privkey = privkeys[pubkey_index]
        withdrawal_credentials = spec.BLS_WITHDRAWAL_PREFIX + spec.hash(pubkey)[1:]
        deposit, root, deposit_data_list = build_deposit(
            spec,
            deposit_data_list=deposit_data_list,
            pubkey=pubkey,
            privkey=privkey,
            amount=amount,
            withdrawal_credentials=withdrawal_credentials,
            signed=signed,
        )
        genesis_deposits.append(deposit)

    return genesis_deposits, root, deposit_data_list


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_initialize_beacon_state_from_eth1(spec):
    deposit_count = spec.config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
    deposits, deposit_root, _ = prepare_full_genesis_deposits(
        spec, spec.MAX_EFFECTIVE_BALANCE, deposit_count, signed=True
    )

    eth1_block_hash = b'\x12' * 32
    eth1_timestamp = spec.config.MIN_GENESIS_TIME

    yield 'eth1_block_hash', 'bytes', eth1_block_hash
    yield 'eth1_timestamp', 'meta', int(eth1_timestamp)

    # initialize beacon_state
    state = spec.initialize_beacon_state_from_eth1(eth1_block_hash, eth1_timestamp, deposits)

    assert state.genesis_time == eth1_timestamp + spec.config.GENESIS_DELAY
    assert len(state.validators) == deposit_count
    assert state.eth1_data.deposit_root == deposit_root
    assert state.eth1_data.deposit_count == deposit_count
    assert state.eth1_data.block_hash == eth1_block_hash
    assert spec.get_total_active_balance(state) == deposit_count * spec.MAX_EFFECTIVE_BALANCE

    # yield state
    yield 'state', state


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_initialize_beacon_state_some_small_balances(spec):
    main_deposit_count = spec.config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
    main_deposits, _, deposit_data_list = prepare_full_genesis_deposits(
        spec, spec.MAX_EFFECTIVE_BALANCE,
        deposit_count=main_deposit_count, signed=True,
    )
    # For deposits above, and for another deposit of this count, add a balance of EFFECTIVE_BALANCE_INCREMENT
    # overlapping pubkeys: half are top-ups of the main deposits
    small_deposit_count = main_deposit_count * 2
    small_deposits, deposit_root, _ = prepare_full_genesis_deposits(
        spec, spec.MIN_DEPOSIT_AMOUNT,
        deposit_count=small_deposit_count,
        min_pubkey_index=0,
        signed=True,
        deposit_data_list=deposit_data_list,
    )
    deposits = main_deposits + small_deposits

    eth1_block_hash = b'\x12' * 32
    eth1_timestamp = spec.config.MIN_GENESIS_TIME

    yield 'eth1_block_hash', 'bytes', eth1_block_hash
    yield 'eth1_timestamp', 'meta', int(eth1_timestamp)

    # initialize beacon_state
    state = spec.initialize_beacon_state_from_eth1(eth1_block_hash, eth1_timestamp, deposits)

    assert state.genesis_time == eth1_timestamp + spec.config.GENESIS_DELAY
    assert len(state.validators) == small_deposit_count
    assert state.eth1_data.deposit_root == deposit_root
    assert state.eth1_data.deposit_count == len(deposits)
    assert state.eth1_data.block_hash == eth1_block_hash
    # only main deposits participate to the active balance
    assert spec.get_total_active_balance(state) == main_deposit_count * spec.MAX_EFFECTIVE_BALANCE

    # yield state
    yield 'state', state


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_is_valid_genesis_state_true(spec):
    state = create_valid_beacon_state(spec)

    yield 'genesis', state
    assert spec.is_valid_genesis_state(state)
    yield 'is_valid', 'meta', True


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_is_valid_genesis_state_false_invalid_timestamp(spec):
    state = create_valid_beacon_state(spec)
    state.genesis_time = spec.config.MIN_GENESIS_TIME - 1

    yield 'genesis', state
    assert not spec.is_valid_genesis_state(state)
    yield 'is_valid', 'meta', False


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_is_valid_genesis_state_false_not_enough_validator(spec):
    state = create_valid_beacon_state(spec)
    state.validators[0].activation_epoch = spec.FAR_FUTURE_EPOCH

    yield 'genesis', state
    assert not spec.is_valid_genesis_state(state)
    yield 'is_valid', 'meta', False


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_is_valid_genesis_state_true_more_balance(spec):
    # an over-funded validator set is still a valid genesis
    state = create_valid_beacon_state(spec)
    state.validators[0].effective_balance = spec.MAX_EFFECTIVE_BALANCE
    state.balances[0] = spec.MAX_EFFECTIVE_BALANCE + spec.EFFECTIVE_BALANCE_INCREMENT

    yield 'genesis', state
    assert spec.is_valid_genesis_state(state)
    yield 'is_valid', 'meta', True


@with_phases([PHASE0])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_is_valid_genesis_state_true_one_more_validator(spec):
    deposit_count = int(spec.config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT) + 1
    deposits, _, _ = prepare_full_genesis_deposits(
        spec, spec.MAX_EFFECTIVE_BALANCE, deposit_count, signed=True
    )
    state = spec.initialize_beacon_state_from_eth1(
        b'\x12' * 32, spec.config.MIN_GENESIS_TIME, deposits
    )

    yield 'genesis', state
    assert spec.is_valid_genesis_state(state)
    yield 'is_valid', 'meta', True
