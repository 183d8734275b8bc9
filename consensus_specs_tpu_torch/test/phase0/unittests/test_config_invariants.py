"""Config/preset invariant unit tests
(spec: the constant tables of reference specs/phase0/beacon-chain.md:173-313;
scenario coverage modeled on the reference's
phase0/unittests/test_config_invariants.py, written for this harness)."""
from ...context import spec_state_test, with_all_phases


@with_all_phases
@spec_state_test
def test_time(spec, state):
    assert spec.config.SECONDS_PER_SLOT > 0
    assert spec.SLOTS_PER_EPOCH > 0
    assert spec.MIN_ATTESTATION_INCLUSION_DELAY >= 1
    assert spec.SLOTS_PER_EPOCH >= spec.MIN_ATTESTATION_INCLUSION_DELAY
    assert spec.SLOTS_PER_HISTORICAL_ROOT % spec.SLOTS_PER_EPOCH == 0
    assert spec.SLOTS_PER_EPOCH <= spec.SLOTS_PER_HISTORICAL_ROOT
    assert spec.MIN_SEED_LOOKAHEAD < spec.MAX_SEED_LOOKAHEAD


@with_all_phases
@spec_state_test
def test_balances(spec, state):
    assert spec.MAX_EFFECTIVE_BALANCE % spec.EFFECTIVE_BALANCE_INCREMENT == 0
    assert spec.MIN_DEPOSIT_AMOUNT > 0
    assert spec.MAX_EFFECTIVE_BALANCE >= spec.MIN_DEPOSIT_AMOUNT
    assert spec.config.EJECTION_BALANCE < spec.MAX_EFFECTIVE_BALANCE


@with_all_phases
@spec_state_test
def test_hysteresis_quotient(spec, state):
    assert spec.HYSTERESIS_QUOTIENT > 0
    assert spec.HYSTERESIS_UPWARD_MULTIPLIER >= spec.HYSTERESIS_QUOTIENT
    assert spec.HYSTERESIS_DOWNWARD_MULTIPLIER <= spec.HYSTERESIS_QUOTIENT


@with_all_phases
@spec_state_test
def test_incentives(spec, state):
    # the whistleblower reward must not exceed what slashing takes away
    if hasattr(spec, "MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR") and spec.fork != "phase0":
        assert (
            spec.WHISTLEBLOWER_REWARD_QUOTIENT
            >= spec.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR // 8
        )
    assert spec.WHISTLEBLOWER_REWARD_QUOTIENT > 0
    assert spec.PROPOSER_REWARD_QUOTIENT > 0
    assert spec.INACTIVITY_PENALTY_QUOTIENT > 0
    assert spec.MIN_SLASHING_PENALTY_QUOTIENT > 0


@with_all_phases
@spec_state_test
def test_shuffling_and_committees(spec, state):
    # 90 on mainnet; the minimal preset trims to 10 (presets/*/phase0.yaml)
    assert spec.SHUFFLE_ROUND_COUNT > 0
    if spec.preset_base == "mainnet":
        assert spec.SHUFFLE_ROUND_COUNT == 90
    assert spec.MAX_COMMITTEES_PER_SLOT >= 1
    assert spec.TARGET_COMMITTEE_SIZE >= 1
    # the aggregator threshold subdivides committees meaningfully
    assert spec.TARGET_AGGREGATORS_PER_COMMITTEE >= 1
    assert spec.MAX_VALIDATORS_PER_COMMITTEE >= spec.TARGET_COMMITTEE_SIZE


@with_all_phases
@spec_state_test
def test_fork_epochs_ordered(spec, state):
    # later forks never activate before earlier ones
    assert spec.config.ALTAIR_FORK_EPOCH <= spec.config.MERGE_FORK_EPOCH
    assert spec.config.GENESIS_FORK_VERSION != spec.config.ALTAIR_FORK_VERSION
    assert spec.config.ALTAIR_FORK_VERSION != spec.config.MERGE_FORK_VERSION


@with_all_phases
@spec_state_test
def test_containers_sized_for_limits(spec, state):
    assert spec.VALIDATOR_REGISTRY_LIMIT >= len(state.validators)
    assert spec.HISTORICAL_ROOTS_LIMIT > 0
    assert spec.EPOCHS_PER_HISTORICAL_VECTOR > spec.EPOCHS_PER_SLASHINGS_VECTOR // spec.EPOCHS_PER_SLASHINGS_VECTOR
    assert spec.EPOCHS_PER_HISTORICAL_VECTOR >= spec.MAX_SEED_LOOKAHEAD + 2
