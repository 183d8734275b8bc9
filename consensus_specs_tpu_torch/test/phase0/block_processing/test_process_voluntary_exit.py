"""process_voluntary_exit handler tests
(reference: test/phase0/block_processing/test_process_voluntary_exit.py)."""
from ...context import always_bls, spec_state_test, with_all_phases
from ...helpers.keys import privkeys
from ...helpers.voluntary_exits import (
    run_voluntary_exit_processing, sign_voluntary_exit,
)


def _fast_forward_to_exitable(spec, state):
    # move state forward SHARD_COMMITTEE_PERIOD epochs to allow for exit
    state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH


@with_all_phases
@spec_state_test
def test_success(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index]

    signed_voluntary_exit = sign_voluntary_exit(
        spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=validator_index), privkey)

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_signature(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index + 1]  # wrong key

    signed_voluntary_exit = sign_voluntary_exit(
        spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=validator_index), privkey)

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=False)


@with_all_phases
@spec_state_test
def test_success_exit_queue__min_churn(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    churn_limit = spec.get_validator_churn_limit(state)

    # exit `MAX_EXITS_PER_EPOCH`
    initial_indices = spec.get_active_validator_indices(state, current_epoch)[:churn_limit]

    # Prepare a bunch of exits, based on the current state
    exit_queue = []
    for index in initial_indices:
        privkey = privkeys[index]
        signed_voluntary_exit = sign_voluntary_exit(
            spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=index), privkey)
        exit_queue.append(signed_voluntary_exit)

    # Now run all the exits
    for voluntary_exit in exit_queue:
        # the function yields data, but we are just interested in running it here, ignore yields.
        for _ in run_voluntary_exit_processing(spec, state, voluntary_exit):
            continue

    # exit an additional validator
    validator_index = spec.get_active_validator_indices(state, current_epoch)[-1]
    privkey = privkeys[validator_index]
    signed_voluntary_exit = sign_voluntary_exit(
        spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=validator_index), privkey)

    # This is the interesting part of the test: on a pre-state with a full exit queue,
    #  when processing an additional exit, it results in an exit in a later epoch
    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit)

    for index in initial_indices:
        assert (
            state.validators[validator_index].exit_epoch ==
            state.validators[index].exit_epoch + 1
        )


@with_all_phases
@spec_state_test
def test_validator_exit_in_future(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index]

    voluntary_exit = spec.VoluntaryExit(
        epoch=current_epoch + 1,
        validator_index=validator_index,
    )
    signed_voluntary_exit = sign_voluntary_exit(spec, state, voluntary_exit, privkey)

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=False)


@with_all_phases
@spec_state_test
def test_validator_invalid_validator_index(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index]

    voluntary_exit = spec.VoluntaryExit(
        epoch=current_epoch,
        validator_index=len(state.validators),
    )
    signed_voluntary_exit = sign_voluntary_exit(spec, state, voluntary_exit, privkey)

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=False)


@with_all_phases
@spec_state_test
def test_validator_not_active(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index]

    state.validators[validator_index].activation_epoch = spec.FAR_FUTURE_EPOCH

    signed_voluntary_exit = sign_voluntary_exit(
        spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=validator_index), privkey)

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=False)


@with_all_phases
@spec_state_test
def test_validator_already_exited(spec, state):
    _fast_forward_to_exitable(spec, state)

    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index]

    # but validator already has exited
    state.validators[validator_index].exit_epoch = current_epoch + 2

    signed_voluntary_exit = sign_voluntary_exit(
        spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=validator_index), privkey)

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=False)


@with_all_phases
@spec_state_test
def test_validator_not_active_long_enough(spec, state):
    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[0]
    privkey = privkeys[validator_index]

    signed_voluntary_exit = sign_voluntary_exit(
        spec, state, spec.VoluntaryExit(epoch=current_epoch, validator_index=validator_index), privkey)

    assert (
        current_epoch - state.validators[validator_index].activation_epoch <
        spec.config.SHARD_COMMITTEE_PERIOD
    )

    yield from run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=False)


@with_all_phases
@spec_state_test
def test_default_exit_epoch_subsequent_exit(spec, state):
    # a second exit in the same epoch lands on the SAME earliest exit epoch
    # until the churn fills
    _fast_forward_to_exitable(spec, state)
    current_epoch = spec.get_current_epoch(state)
    indices = spec.get_active_validator_indices(state, current_epoch)[-2:]

    first = sign_voluntary_exit(
        spec, state,
        spec.VoluntaryExit(epoch=current_epoch, validator_index=indices[0]),
        privkeys[indices[0]],
    )
    spec.process_voluntary_exit(state, first)
    first_exit_epoch = state.validators[indices[0]].exit_epoch

    second = sign_voluntary_exit(
        spec, state,
        spec.VoluntaryExit(epoch=current_epoch, validator_index=indices[1]),
        privkeys[indices[1]],
    )
    yield from run_voluntary_exit_processing(spec, state, second)
    assert state.validators[indices[1]].exit_epoch == first_exit_epoch


@with_all_phases
@spec_state_test
def test_exit_queue_spills_past_churn(spec, state):
    # more exits than the per-epoch churn: the queue epoch advances
    _fast_forward_to_exitable(spec, state)
    current_epoch = spec.get_current_epoch(state)
    churn = int(spec.get_validator_churn_limit(state))
    indices = spec.get_active_validator_indices(state, current_epoch)[: churn + 1]

    for index in indices[:-1]:
        exit_op = sign_voluntary_exit(
            spec, state,
            spec.VoluntaryExit(epoch=current_epoch, validator_index=index),
            privkeys[index],
        )
        spec.process_voluntary_exit(state, exit_op)
    base_epoch = state.validators[indices[0]].exit_epoch

    last = sign_voluntary_exit(
        spec, state,
        spec.VoluntaryExit(epoch=current_epoch, validator_index=indices[-1]),
        privkeys[indices[-1]],
    )
    yield from run_voluntary_exit_processing(spec, state, last)
    assert state.validators[indices[-1]].exit_epoch == base_epoch + 1


from ...context import (  # noqa: E402
    MINIMAL, default_activation_threshold, scaled_churn_balances, spec_test,
    with_custom_state, with_presets,
)


@with_all_phases
@with_presets([MINIMAL], reason="mainnet-scale scaled-churn registry exceeds the key pool")
@spec_test
@with_custom_state(scaled_churn_balances, default_activation_threshold)
def test_success_exit_queue_scaled_churn(spec, state):
    _fast_forward_to_exitable(spec, state)
    churn = int(spec.get_validator_churn_limit(state))
    assert churn > int(spec.config.MIN_PER_EPOCH_CHURN_LIMIT)

    # fill one epoch's churn exactly, then one more: the spillover's exit
    # epoch must be one later than the batch's
    active = list(spec.get_active_validator_indices(state, spec.get_current_epoch(state)))
    batch, extra = active[:churn], active[churn]
    for i in batch:
        exit_op = sign_voluntary_exit(
            spec, state,
            spec.VoluntaryExit(
                epoch=spec.get_current_epoch(state), validator_index=i
            ),
            privkeys[i],
        )
        spec.process_voluntary_exit(state, exit_op)
    batch_epochs = {int(state.validators[i].exit_epoch) for i in batch}
    assert len(batch_epochs) == 1

    exit_op = sign_voluntary_exit(
        spec, state,
        spec.VoluntaryExit(
            epoch=spec.get_current_epoch(state), validator_index=extra
        ),
        privkeys[extra],
    )
    yield from run_voluntary_exit_processing(spec, state, exit_op)
    assert int(state.validators[extra].exit_epoch) == next(iter(batch_epochs)) + 1
