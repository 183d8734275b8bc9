"""Epoch-processing sub-pass runners (reference: test/helpers/epoch_processing.py)."""


def get_process_calls(spec):
    # ordered epoch-processing sub-passes per fork; fork-dependent because
    # the altair namespace still carries phase0's superseded passes
    # (reference specs/phase0/beacon-chain.md:1286-1298; altair:567-583)
    from .forks import is_post_altair, is_post_custody_game, is_post_sharding

    if is_post_custody_game(spec):
        # custody passes interleave with the sharding/base pipeline
        # (reference specs/custody_game/beacon-chain.md:616-647)
        return [
            'process_pending_shard_confirmations',
            'reset_pending_shard_work',
            'process_justification_and_finalization',
            'process_inactivity_updates',
            'process_rewards_and_penalties',
            'process_registry_updates',
            'process_reveal_deadlines',
            'process_challenge_deadlines',
            'process_slashings',
            'process_eth1_data_reset',
            'process_effective_balance_updates',
            'process_slashings_reset',
            'process_randao_mixes_reset',
            'process_historical_roots_update',
            'process_participation_flag_updates',
            'process_sync_committee_updates',
            'process_custody_final_updates',
        ]
    if is_post_sharding(spec):
        # sharding pre-processing runs before the base passes
        # (reference specs/sharding/beacon-chain.md:811-830)
        return [
            'process_pending_shard_confirmations',
            'reset_pending_shard_work',
            'process_justification_and_finalization',
            'process_inactivity_updates',
            'process_rewards_and_penalties',
            'process_registry_updates',
            'process_slashings',
            'process_eth1_data_reset',
            'process_effective_balance_updates',
            'process_slashings_reset',
            'process_randao_mixes_reset',
            'process_historical_roots_update',
            'process_participation_flag_updates',
            'process_sync_committee_updates',
        ]
    if is_post_altair(spec):
        return [
            'process_justification_and_finalization',
            'process_inactivity_updates',
            'process_rewards_and_penalties',
            'process_registry_updates',
            'process_slashings',
            'process_eth1_data_reset',
            'process_effective_balance_updates',
            'process_slashings_reset',
            'process_randao_mixes_reset',
            'process_historical_roots_update',
            'process_participation_flag_updates',
            'process_sync_committee_updates',
        ]
    return [
        'process_justification_and_finalization',
        'process_rewards_and_penalties',
        'process_registry_updates',
        'process_slashings',
        'process_eth1_data_reset',
        'process_effective_balance_updates',
        'process_slashings_reset',
        'process_randao_mixes_reset',
        'process_historical_roots_update',
        'process_participation_record_updates',
    ]


def run_epoch_processing_to(spec, state, process_name):
    """Processes to the next epoch transition, up to (but not including) the
    sub-transition named ``process_name``."""
    slot = state.slot + (spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH)

    # transition state to slot before epoch state transition
    if state.slot < slot - 1:
        spec.process_slots(state, slot - 1)

    # start transitioning, do one slot update before the epoch itself.
    spec.process_slot(state)

    # process components of epoch transition before final-updates
    for name in get_process_calls(spec):
        if name == process_name:
            break
        # only run when present. Later phases introduce more to the epoch-processing.
        if hasattr(spec, name):
            getattr(spec, name)(state)


def run_epoch_processing_with(spec, state, process_name):
    """Processes to the next epoch transition, up to the sub-transition named
    ``process_name``, yielding (pre, post) test-vector parts."""
    run_epoch_processing_to(spec, state, process_name)
    yield 'pre', state
    getattr(spec, process_name)(state)
    yield 'post', state
