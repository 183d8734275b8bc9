"""Genesis-state factory for the test harness.

Role parity with the reference's
genesis helper: install validators DIRECTLY into a fresh state — replaying
genesis deposits per test would dominate suite runtime — wire the fork
version/eth1 stub fields, then apply the per-fork state extensions
(altair participation + sync committees, merge payload header, sharding
fee market + builders, custody reveal epochs).
"""
from .forks import is_post_altair, is_post_custody_game, is_post_merge, is_post_sharding
from .keys import pubkeys

_ETH1_STUB_ROOT = b"\x42" * 32
_ETH1_STUB_HASH = b"\xda" * 32


def _fork_versions(spec):
    """(previous, current) version pair for a state born directly at this
    fork. The draft forks share the reference config's SHARDING_FORK_VERSION
    (neither draft defines its own)."""
    genesis = spec.config.GENESIS_FORK_VERSION
    if spec.fork == "phase0":
        return genesis, genesis
    if spec.fork == "altair":
        return genesis, spec.config.ALTAIR_FORK_VERSION
    if is_post_sharding(spec):
        return spec.config.MERGE_FORK_VERSION, spec.config.SHARDING_FORK_VERSION
    return spec.config.ALTAIR_FORK_VERSION, spec.config.MERGE_FORK_VERSION


def build_mock_validator(spec, i, balance, activation_threshold):
    """A registry entry for key ``i``: withdrawal credentials derive from
    the same key (tests never withdraw), effective balance rounded down to
    the increment and capped."""
    effective = min(
        balance - balance % spec.EFFECTIVE_BALANCE_INCREMENT,
        spec.MAX_EFFECTIVE_BALANCE,
    )
    return spec.Validator(
        pubkey=pubkeys[i],
        withdrawal_credentials=spec.BLS_WITHDRAWAL_PREFIX + spec.hash(pubkeys[i])[1:],
        effective_balance=effective,
        activation_eligibility_epoch=spec.FAR_FUTURE_EPOCH,
        activation_epoch=spec.FAR_FUTURE_EPOCH,
        exit_epoch=spec.FAR_FUTURE_EPOCH,
        withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
    )


def _install_registry(spec, state, balances, activation_threshold):
    state.balances = balances
    state.validators = [
        build_mock_validator(spec, i, b, activation_threshold)
        for i, b in enumerate(balances)
    ]
    for v in state.validators:
        if v.effective_balance >= activation_threshold:
            v.activation_eligibility_epoch = spec.GENESIS_EPOCH
            v.activation_epoch = spec.GENESIS_EPOCH
    # domain separation / chain versioning root over the just-built registry
    state.genesis_validators_root = spec.hash_tree_root(state.validators)


def _extend_for_altair(spec, state):
    n = len(state.validators)
    state.previous_epoch_participation = [spec.ParticipationFlags(0)] * n
    state.current_epoch_participation = [spec.ParticipationFlags(0)] * n
    state.inactivity_scores = [spec.uint64(0)] * n
    # both committees start from the genesis registry (what upgrade_to_altair
    # and the altair genesis init both produce)
    state.current_sync_committee = spec.get_next_sync_committee(state)
    state.next_sync_committee = spec.get_next_sync_committee(state)


def _extend_for_sharding(spec, state):
    # the sharding draft runs with execution enabled from genesis
    # (sharding/beacon-chain.md:545), so the state must look merge-complete
    from .execution_payload import build_state_with_complete_transition

    build_state_with_complete_transition(spec, state)
    # no fee-market genesis is specified: start at the configured price
    # floor; the default all-UNCONFIRMED shard buffer is already correct
    # (the first epoch transition arms it via reset_pending_shard_work)
    state.shard_sample_price = spec.MIN_SAMPLE_PRICE
    n_builders = 4
    # builder keys come off the TAIL of the shared pool; a registry close
    # to the pool size would alias builder and validator keys and corrupt
    # signature-domain tests — refuse instead
    assert len(state.validators) + n_builders <= len(pubkeys), (
        "validator count leaves no headroom for distinct builder keys"
    )
    state.blob_builders = [
        spec.Builder(pubkey=pubkeys[len(pubkeys) - 1 - i]) for i in range(n_builders)
    ]
    state.blob_builder_balances = [spec.Gwei(2**40)] * n_builders


def create_genesis_state(spec, validator_balances, activation_threshold):
    prev_v, cur_v = _fork_versions(spec)
    state = spec.BeaconState(
        genesis_time=0,
        fork=spec.Fork(
            previous_version=prev_v, current_version=cur_v, epoch=spec.GENESIS_EPOCH
        ),
        eth1_data=spec.Eth1Data(
            deposit_root=_ETH1_STUB_ROOT,
            deposit_count=len(validator_balances),
            block_hash=_ETH1_STUB_HASH,
        ),
        eth1_deposit_index=len(validator_balances),
        latest_block_header=spec.BeaconBlockHeader(
            body_root=spec.hash_tree_root(spec.BeaconBlockBody())
        ),
        randao_mixes=[_ETH1_STUB_HASH] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
    )
    _install_registry(spec, state, validator_balances, activation_threshold)

    if is_post_altair(spec):
        _extend_for_altair(spec, state)
    if is_post_merge(spec):
        state.latest_execution_payload_header = spec.ExecutionPayloadHeader()
    if is_post_sharding(spec):
        _extend_for_sharding(spec, state)
    if is_post_custody_game(spec):
        for v in state.validators:
            v.all_custody_secrets_revealed_epoch = spec.FAR_FUTURE_EPOCH
    return state
