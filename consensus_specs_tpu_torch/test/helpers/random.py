"""Seeded state/block randomizers for property-style scenarios.

Own design; fills the role of the reference's test/helpers/random.py (200
LoC) + test/utils/randomized_block_tests.py scenario vocabulary: mutate the
state into unusual-but-legal shapes, then drive full transitions with
randomly composed blocks and let the spec's own asserts be the oracle.
"""
from .attestations import get_valid_attestation
from .block import build_empty_block_for_next_slot
from .forks import is_post_altair
from .state import state_transition_and_sign_block
from .voluntary_exits import prepare_signed_exits


def randomize_balances(spec, state, rng):
    for i in range(len(state.validators)):
        roll = rng.random()
        if roll < 0.1:
            state.balances[i] = spec.Gwei(0)
        elif roll < 0.3:
            state.balances[i] = spec.Gwei(
                rng.randrange(int(spec.config.EJECTION_BALANCE))
            )
        else:
            state.balances[i] = spec.Gwei(
                rng.randrange(int(spec.MAX_EFFECTIVE_BALANCE * 2))
            )


def randomize_effective_balances(spec, state, rng):
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    for v in state.validators:
        v.effective_balance = spec.Gwei(
            rng.randrange(0, int(spec.MAX_EFFECTIVE_BALANCE) + increment, increment)
        )


def slash_random_validators(spec, state, rng, fraction=0.1):
    out = []
    for i in range(len(state.validators)):
        if rng.random() < fraction:
            spec.slash_validator(state, spec.ValidatorIndex(i))
            out.append(i)
    return out


def randomize_participation(spec, state, rng):
    if is_post_altair(spec):
        n = len(state.validators)
        state.previous_epoch_participation = [
            spec.ParticipationFlags(rng.randrange(8)) for _ in range(n)
        ]
        state.current_epoch_participation = [
            spec.ParticipationFlags(rng.randrange(8)) for _ in range(n)
        ]
        state.inactivity_scores = [
            spec.uint64(rng.randrange(0, 50)) for _ in range(n)
        ]


def random_block(spec, state, rng, exited: set):
    """A valid-by-construction block carrying a random operation mix
    (attestations, exits, proposer/attester slashings, deposit top-ups —
    the multi-operation composition the reference's
    helpers/multi_operations.py provides)."""
    from .attester_slashings import get_valid_attester_slashing
    from .deposits import prepare_state_and_deposit
    from .proposer_slashings import get_valid_proposer_slashing

    # deposits FIRST: prepare_state_and_deposit rewrites state.eth1_data,
    # which feeds the state root the block's parent header snapshots
    pending_deposit = None
    if rng.random() < 0.15:
        index = rng.randrange(len(state.validators))
        amount = spec.Gwei(rng.randrange(1, int(spec.MAX_EFFECTIVE_BALANCE) // 4))
        pending_deposit = prepare_state_and_deposit(
            spec, state, index, amount, signed=True
        )

    block = build_empty_block_for_next_slot(spec, state)
    if pending_deposit is not None:
        block.body.deposits.append(pending_deposit)
        block.body.eth1_data.deposit_count = state.eth1_deposit_index + 1
    # occasional proposer slashing of a not-yet-slashed validator
    if rng.random() < 0.15:
        try:
            ps = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
            if not state.validators[ps.signed_header_1.message.proposer_index].slashed:
                block.body.proposer_slashings.append(ps)
        except Exception:
            pass  # no eligible proposer in this state shape
    # occasional attester slashing
    if rng.random() < 0.1:
        try:
            aslash = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
            index = aslash.attestation_1.attesting_indices[0]
            if not state.validators[index].slashed:
                block.body.attester_slashings.append(aslash)
        except Exception:
            pass
    # random attestations for an includable slot
    if state.slot >= spec.MIN_ATTESTATION_INCLUSION_DELAY and rng.random() < 0.8:
        slot_to_attest = state.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY + 1
        if slot_to_attest >= spec.compute_start_slot_at_epoch(
            spec.get_current_epoch(state)
        ):
            def sample(participants):
                return set(v for v in participants if rng.random() < 0.8)

            attestation = get_valid_attestation(
                spec, state, slot=slot_to_attest, signed=True,
                filter_participant_set=sample,
            )
            if any(attestation.aggregation_bits):
                block.body.attestations.append(attestation)
    # occasional voluntary exit (requires enough validator age)
    if rng.random() < 0.2:
        current_epoch = spec.get_current_epoch(state)
        eligible = [
            i for i in spec.get_active_validator_indices(state, current_epoch)
            if current_epoch >= state.validators[i].activation_epoch
            + spec.config.SHARD_COMMITTEE_PERIOD
            and i not in exited
            and int(state.validators[i].exit_epoch) == int(spec.FAR_FUTURE_EPOCH)
        ]
        if eligible:
            index = rng.choice(eligible)
            block.body.voluntary_exits = prepare_signed_exits(spec, state, [index])
            exited.add(index)
    # altair+: random sync-committee participation, signed over the parent
    # root the block actually carries (cycling density per block). Built
    # from a forwarded state so period-boundary committee rotations are
    # honored.
    if is_post_altair(spec):
        from .sync_committee import build_sync_aggregate

        density = rng.choice([0.0, 0.25, 0.7, 1.0])
        bits = [rng.random() < density for _ in range(int(spec.SYNC_COMMITTEE_SIZE))]
        at_slot = state
        if state.slot < block.slot:
            at_slot = state.copy()
            spec.process_slots(at_slot, block.slot)
        block.body.sync_aggregate = build_sync_aggregate(
            spec, at_slot, bits, slot=block.slot, block_root=block.parent_root
        )
    return block


def run_random_scenario(spec, state, rng, slots):
    """Drive ``slots`` of maybe-empty random blocks through the full
    transition; the spec's asserts are the test oracle."""
    exited: set = set()
    signed_blocks = []
    for _ in range(slots):
        if rng.random() < 0.15 or _next_proposer_slashed(spec, state):
            # skipped slot (deliberate, or the due proposer was slashed by an
            # earlier block — a live chain skips that slot too)
            spec.process_slots(state, state.slot + 1)
            continue
        block = random_block(spec, state, rng, exited)
        signed_blocks.append(state_transition_and_sign_block(spec, state, block))
    return signed_blocks


def _next_proposer_slashed(spec, state) -> bool:
    tmp = state.copy()
    spec.process_slots(tmp, tmp.slot + 1)
    return bool(tmp.validators[spec.get_beacon_proposer_index(tmp)].slashed)


def randomize_registry_for_upgrade(spec, state, seed, include_activation=False):
    """Perturb a quarter of the registry (slashings, exits, balances — and
    optionally pending activations) ahead of a fork-upgrade test."""
    from random import Random

    rng = Random(seed)
    for index in rng.sample(range(len(state.validators)), len(state.validators) // 4):
        v = state.validators[index]
        choice = rng.randrange(4 if include_activation else 3)
        if choice == 0:
            v.slashed = True
            v.exit_epoch = spec.get_current_epoch(state)
            v.withdrawable_epoch = spec.get_current_epoch(state) + 16
        elif choice == 1:
            v.exit_epoch = spec.get_current_epoch(state) + rng.randrange(1, 8)
        elif choice == 3:
            v.activation_epoch = spec.FAR_FUTURE_EPOCH
            v.activation_eligibility_epoch = spec.get_current_epoch(state) + 1
        state.balances[index] = spec.Gwei(rng.randrange(1, 2 * 10**9))
        if hasattr(state, 'inactivity_scores'):
            state.inactivity_scores[index] = spec.uint64(rng.randrange(0, 50))
