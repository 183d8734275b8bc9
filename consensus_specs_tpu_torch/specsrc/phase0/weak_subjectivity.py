# Phase 0 — Weak Subjectivity Guide (executable spec source)
#
# Capability parity with reference specs/phase0/weak-subjectivity.md.

ETH_TO_GWEI = uint64(10**9)
SAFETY_DECAY = uint64(10)  # percent


@dataclass
class WeakSubjectivityCheckpoint(object):
    root: Root
    epoch: Epoch


def compute_weak_subjectivity_period(state: BeaconState) -> uint64:
    """Returns the weak subjectivity period for the current ``state``:
    churn-limit + balance-top-up bound (weak-subjectivity.md:84-118)."""
    ws_period = config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    N = len(get_active_validator_indices(state, get_current_epoch(state)))
    t = get_total_active_balance(state) // N // ETH_TO_GWEI
    T = MAX_EFFECTIVE_BALANCE // ETH_TO_GWEI
    delta = get_validator_churn_limit(state)
    Delta = MAX_DEPOSITS * SLOTS_PER_EPOCH
    D = SAFETY_DECAY

    if T * (200 + 3 * D) < t * (200 + 12 * D):
        epochs_for_validator_set_churn = (
            N * (t * (200 + 12 * D) - T * (200 + 3 * D)) // (600 * delta * (2 * t + T))
        )
        epochs_for_balance_top_ups = (
            N * (200 + 3 * D) // (600 * Delta)
        )
        ws_period += max(epochs_for_validator_set_churn, epochs_for_balance_top_ups)
    else:
        ws_period += (
            3 * N * D * t // (200 * Delta * (T - t))
        )

    return ws_period


def is_within_weak_subjectivity_period(store, ws_state: BeaconState,
                                       ws_checkpoint) -> bool:
    # (weak-subjectivity.md:168-180)
    # Clients may choose to validate the input state against the input Weak Subjectivity Checkpoint
    assert ws_state.latest_block_header.state_root == ws_checkpoint.root
    assert compute_epoch_at_slot(ws_state.slot) == ws_checkpoint.epoch

    ws_period = compute_weak_subjectivity_period(ws_state)
    ws_state_epoch = compute_epoch_at_slot(ws_state.slot)
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    return current_epoch <= ws_state_epoch + ws_period
