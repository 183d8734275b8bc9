# Custody Game (draft) — The Beacon Chain (executable spec source)
#
# Provenance: function bodies transcribed from the draft spec text (reference
# specs/custody_game/beacon-chain.md) — conformance requires identical
# semantics wherever the draft is self-consistent. Exec'd after the sharding
# sources into the same namespace.
#
# The reference does NOT compile this fork, and its custody draft is written
# against a STALE sharding layer that v1.1.3's own sharding/beacon-chain.md
# no longer defines (`ShardTransition`, `attestation.data.shard_transition_root`,
# `process_pending_headers`, `process_light_client_aggregate`, ...). To make
# the fork executable, those cross-references are adapted to the current
# sharding draft — every adaptation is marked "[Adapted]":
#   * CustodyChunkChallenge/CustodySlashing carry the attested
#     `ShardBlobHeader` (tied to `attestation.data.shard_blob_root`) instead
#     of the nonexistent `ShardTransition`.
#   * Blob byte-length is `samples_count * BYTES_PER_SAMPLE` (248-byte
#     samples, sharding/beacon-chain.md:103).
#   * `compute_custody_data_root` defines the canonical chunk tree that
#     `body_summary.data_root` commits to for custody purposes, giving the
#     response merkle check (depth CUSTODY_RESPONSE_DEPTH + 1 with the
#     byte-length mixed in) a concrete tree to verify against.
#   * process_block/process_epoch extend the CURRENT sharding versions
#     (the draft text extends a stale phase0-era pipeline).
#
# KNOWN DRAFT INCONSISTENCY (inherited, deliberately NOT reconciled):
# `body_summary.data_root` has two irreconcilable meanings across the layered
# drafts. The sharding draft defines it as hash_tree_root(List[BLSPoint])
# (32-byte field-element serialization, sharding/beacon-chain.md:260-331),
# while the custody handlers here require compute_custody_data_root over
# samples_count * 248 raw bytes. Consequently a header accepted by
# process_shard_header with a real KZG commitment (helpers/shard_blob.py)
# can never satisfy a chunk-challenge response or custody slashing, and
# custody-test headers carry empty commitments that process_shard_header
# would reject. The two subsystems are therefore exercised by DISJOINT test
# fixtures. Reconciling (defining the sharding data field as the
# 248-byte/sample ByteList view so one blob satisfies both) would diverge
# from the normative sharding text, so the split is kept and documented.

# ---------------------------------------------------------------------------
# constants (custody_game/beacon-chain.md:63-80)
# ---------------------------------------------------------------------------

CUSTODY_PRIME = int(2 ** 256 - 189)
CUSTODY_SECRETS = uint64(3)
BYTES_PER_CUSTODY_ATOM = uint64(32)
CUSTODY_PROBABILITY_EXPONENT = uint64(10)

DOMAIN_CUSTODY_BIT_SLASHING = DomainType(b'\x83\x00\x00\x00')

# preset (presets/*/custody_game.yaml): RANDAO_PENALTY_EPOCHS,
# EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS, EPOCHS_PER_CUSTODY_PERIOD,
# CUSTODY_PERIOD_TO_RANDAO_PADDING, MAX_CHUNK_CHALLENGE_DELAY,
# MAX_CUSTODY_* limits, BYTES_PER_CUSTODY_CHUNK,
# EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE, MINOR_REWARD_QUOTIENT

# [Adapted] the stale draft sized responses by MAX_SHARD_BLOCK_SIZE; the
# current sharding draft's blob ceiling in bytes:
BYTES_PER_SAMPLE = uint64(31) * POINTS_PER_SAMPLE  # 248 (sharding/beacon-chain.md:103)
MAX_SHARD_BLOCK_SIZE = MAX_SAMPLES_PER_BLOB * BYTES_PER_SAMPLE
CUSTODY_RESPONSE_DEPTH = ceillog2(MAX_SHARD_BLOCK_SIZE // BYTES_PER_CUSTODY_CHUNK)


# ---------------------------------------------------------------------------
# extended types (custody_game/beacon-chain.md:122-158)
# ---------------------------------------------------------------------------

class Validator(Validator):
    # next_custody_secret_to_reveal is initialised to the custody period
    # (of the particular validator) in which the validator is activated
    # = get_custody_period_for_validator(...)
    next_custody_secret_to_reveal: uint64
    all_custody_secrets_revealed_epoch: Epoch  # to be initialized to FAR_FUTURE_EPOCH


# ---------------------------------------------------------------------------
# new operations (custody_game/beacon-chain.md:161-243)
# ---------------------------------------------------------------------------

class CustodyChunkChallenge(Container):
    responder_index: ValidatorIndex
    shard_blob_header: ShardBlobHeader  # [Adapted] was: shard_transition: ShardTransition
    attestation: Attestation
    chunk_index: uint64


class CustodyChunkChallengeRecord(Container):
    challenge_index: uint64
    challenger_index: ValidatorIndex
    responder_index: ValidatorIndex
    inclusion_epoch: Epoch
    data_root: Root
    chunk_index: uint64


class CustodyChunkResponse(Container):
    challenge_index: uint64
    chunk_index: uint64
    chunk: ByteVector[BYTES_PER_CUSTODY_CHUNK]
    branch: Vector[Root, CUSTODY_RESPONSE_DEPTH + 1]


class CustodySlashing(Container):
    # The attested ShardBlobHeader's data is the custody object.
    malefactor_index: ValidatorIndex
    malefactor_secret: BLSSignature
    whistleblower_index: ValidatorIndex
    shard_blob_header: ShardBlobHeader  # [Adapted] was: shard_transition + data_index
    attestation: Attestation
    data: ByteList[MAX_SHARD_BLOCK_SIZE]


class SignedCustodySlashing(Container):
    message: CustodySlashing
    signature: BLSSignature


class CustodyKeyReveal(Container):
    # Index of the validator whose key is being revealed
    revealer_index: ValidatorIndex
    # Reveal (masked signature)
    reveal: BLSSignature


class EarlyDerivedSecretReveal(Container):
    # Index of the validator whose key is being revealed
    revealed_index: ValidatorIndex
    # RANDAO epoch of the key that is being revealed
    epoch: Epoch
    # Reveal (masked signature)
    reveal: BLSSignature
    # Index of the validator who revealed (whistleblower)
    masker_index: ValidatorIndex
    # Mask used to hide the actual reveal signature (prevent reveal from being stolen)
    mask: Bytes32


# ---------------------------------------------------------------------------
# extended block/state containers (custody_game/beacon-chain.md:134-158)
# ---------------------------------------------------------------------------

class BeaconBlockBody(BeaconBlockBody):
    # Custody game
    chunk_challenges: List[CustodyChunkChallenge, MAX_CUSTODY_CHUNK_CHALLENGES]
    chunk_challenge_responses: List[CustodyChunkResponse, MAX_CUSTODY_CHUNK_CHALLENGE_RESPONSES]
    custody_key_reveals: List[CustodyKeyReveal, MAX_CUSTODY_KEY_REVEALS]
    early_derived_secret_reveals: List[EarlyDerivedSecretReveal, MAX_EARLY_DERIVED_SECRET_REVEALS]
    custody_slashings: List[SignedCustodySlashing, MAX_CUSTODY_SLASHINGS]


class BeaconBlock(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body: BeaconBlockBody


class SignedBeaconBlock(Container):
    message: BeaconBlock
    signature: BLSSignature


class BeaconState(BeaconState):
    # re-bound to the custody-extended Validator
    validators: List[Validator, VALIDATOR_REGISTRY_LIMIT]
    # Future derived secrets already exposed; contains the indices of the exposed validator
    # at RANDAO reveal period % EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS
    exposed_derived_secrets: Vector[List[ValidatorIndex, MAX_EARLY_DERIVED_SECRET_REVEALS * SLOTS_PER_EPOCH],
                                    EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS]
    custody_chunk_challenge_records: List[CustodyChunkChallengeRecord, MAX_CUSTODY_CHUNK_CHALLENGE_RECORDS]
    custody_chunk_challenge_index: uint64


# ---------------------------------------------------------------------------
# helpers (custody_game/beacon-chain.md:246-350)
# ---------------------------------------------------------------------------

def replace_empty_or_append(l: Any, new_element: Any) -> int:
    for i in range(len(l)):
        if l[i] == type(new_element)():
            l[i] = new_element
            return i
    l.append(new_element)
    return len(l) - 1


def legendre_bit(a: int, q: int) -> int:
    """Returns the Legendre symbol ``(a/q)`` normalized as a bit."""
    if a >= q:
        return legendre_bit(a % q, q)
    if a == 0:
        return 0
    assert q > a > 0 and q % 2 == 1
    t = 1
    n = q
    while a != 0:
        while a % 2 == 0:
            a //= 2
            r = n % 8
            if r == 3 or r == 5:
                t = -t
        a, n = n, a
        if a % 4 == n % 4 == 3:
            t = -t
        a %= n
    if n == 1:
        return (t + 1) // 2
    else:
        return 0


def get_custody_atoms(bytez: bytes) -> Sequence[bytes]:
    length_remainder = len(bytez) % BYTES_PER_CUSTODY_ATOM
    bytez += b'\x00' * ((BYTES_PER_CUSTODY_ATOM - length_remainder) % BYTES_PER_CUSTODY_ATOM)  # right-padding
    return [
        bytez[i:i + BYTES_PER_CUSTODY_ATOM]
        for i in range(0, len(bytez), BYTES_PER_CUSTODY_ATOM)
    ]


def get_custody_secrets(key: BLSSignature) -> Sequence[int]:
    # the x-coordinate limbs of the signature's G2 point, little-endian
    # joined and re-chunked into 32-byte ints (the reference accesses
    # py_ecc's FQ2 .coeffs; our oracle returns the ((c0, c1), y) affine)
    full_G2_element = bls.signature_to_G2(key)
    signature = full_G2_element[0]
    signature_bytes = b"".join(x.to_bytes(48, "little") for x in signature)
    secrets = [int.from_bytes(signature_bytes[i:i + BYTES_PER_CUSTODY_ATOM], "little")
               for i in range(0, len(signature_bytes), 32)]
    return secrets


def universal_hash_function(data_chunks: Sequence[bytes], secrets: Sequence[int]) -> int:
    n = len(data_chunks)
    return (
        sum(
            pow(secrets[i % CUSTODY_SECRETS], i, CUSTODY_PRIME) * int.from_bytes(atom, "little") % CUSTODY_PRIME
            for i, atom in enumerate(data_chunks)
        ) + pow(secrets[n % CUSTODY_SECRETS], n, CUSTODY_PRIME)
    ) % CUSTODY_PRIME


def compute_custody_bit(key: BLSSignature, data: Any) -> int:
    custody_atoms = get_custody_atoms(bytes(data))
    secrets = get_custody_secrets(key)
    uhf = universal_hash_function(custody_atoms, secrets)
    legendre_bits = [legendre_bit(uhf + secrets[0] + i, CUSTODY_PRIME)
                     for i in range(CUSTODY_PROBABILITY_EXPONENT)]
    return int(all(legendre_bits))


def get_randao_epoch_for_custody_period(period: uint64, validator_index: ValidatorIndex) -> Epoch:
    next_period_start = (period + 1) * EPOCHS_PER_CUSTODY_PERIOD - validator_index % EPOCHS_PER_CUSTODY_PERIOD
    return Epoch(next_period_start + CUSTODY_PERIOD_TO_RANDAO_PADDING)


def get_custody_period_for_validator(validator_index: ValidatorIndex, epoch: Epoch) -> uint64:
    '''
    Return the reveal period for a given validator.
    '''
    return (epoch + validator_index % EPOCHS_PER_CUSTODY_PERIOD) // EPOCHS_PER_CUSTODY_PERIOD


def compute_custody_data_root(data: Any) -> Root:
    """[Adapted] Canonical custody view of blob bytes: a binary tree over
    per-chunk hash_tree_roots (ByteVector[BYTES_PER_CUSTODY_CHUNK] leaves,
    zero-padded to 2**CUSTODY_RESPONSE_DEPTH), with the byte length mixed in
    at the top — the tree the chunk-response merkle branch verifies against
    (depth CUSTODY_RESPONSE_DEPTH + 1, custody_game/beacon-chain.md:449-456)."""
    bytez = bytes(data)
    chunk_size = int(BYTES_PER_CUSTODY_CHUNK)
    padded_len = max(1, (len(bytez) + chunk_size - 1) // chunk_size) * chunk_size
    padded = bytez + b'\x00' * (padded_len - len(bytez))
    leaves = [
        hash_tree_root(ByteVector[BYTES_PER_CUSTODY_CHUNK](padded[i:i + chunk_size]))
        for i in range(0, len(padded), chunk_size)
    ]
    leaves += [Bytes32()] * (2 ** int(CUSTODY_RESPONSE_DEPTH) - len(leaves))
    nodes = [bytes(leaf) for leaf in leaves]
    while len(nodes) > 1:
        nodes = [hash(nodes[i] + nodes[i + 1]) for i in range(0, len(nodes), 2)]
    return Root(hash(nodes[0] + len(bytez).to_bytes(32, 'little')))


# ---------------------------------------------------------------------------
# block processing (custody_game/beacon-chain.md:353-377)
# ---------------------------------------------------------------------------

# [Adapted] the draft text extends a stale phase0-era process_block; here the
# custody operations append to the CURRENT sharding block pipeline
def process_block(state: BeaconState, block: BeaconBlock) -> None:
    process_block_header(state, block)
    process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)
    process_randao(state, block.body)
    process_eth1_data(state, block.body)
    process_operations(state, block.body)
    process_custody_game_operations(state, block.body)
    process_sync_aggregate(state, block.body.sync_aggregate)


def process_custody_game_operations(state: BeaconState, body: BeaconBlockBody) -> None:
    def for_ops(operations: Sequence[Any], fn: Callable[[BeaconState, Any], None]) -> None:
        for operation in operations:
            fn(state, operation)

    for_ops(body.chunk_challenges, process_chunk_challenge)
    for_ops(body.chunk_challenge_responses, process_chunk_challenge_response)
    for_ops(body.custody_key_reveals, process_custody_key_reveal)
    for_ops(body.early_derived_secret_reveals, process_early_derived_secret_reveal)
    for_ops(body.custody_slashings, process_custody_slashing)


def process_chunk_challenge(state: BeaconState, challenge: CustodyChunkChallenge) -> None:
    # Verify the attestation
    assert is_valid_indexed_attestation(state, get_indexed_attestation(state, challenge.attestation))
    # Verify it is not too late to challenge the attestation
    max_attestation_challenge_epoch = Epoch(challenge.attestation.data.target.epoch + MAX_CHUNK_CHALLENGE_DELAY)
    assert get_current_epoch(state) <= max_attestation_challenge_epoch
    # Verify it is not too late to challenge the responder
    responder = state.validators[challenge.responder_index]
    if responder.exit_epoch < FAR_FUTURE_EPOCH:
        assert get_current_epoch(state) <= responder.exit_epoch + MAX_CHUNK_CHALLENGE_DELAY
    # Verify responder is slashable
    assert is_slashable_validator(responder, get_current_epoch(state))
    # Verify the responder participated in the attestation
    attesters = get_attesting_indices(state, challenge.attestation.data, challenge.attestation.aggregation_bits)
    assert challenge.responder_index in attesters
    # [Adapted] Verify the claimed blob header is the one the attestation vouches for
    assert hash_tree_root(challenge.shard_blob_header) == challenge.attestation.data.shard_blob_root
    body_summary = challenge.shard_blob_header.body_summary
    data_root = body_summary.data_root
    # Verify the challenge is not a duplicate
    for record in state.custody_chunk_challenge_records:
        assert (
            record.data_root != data_root or
            record.chunk_index != challenge.chunk_index
        )
    # Verify depth — [Adapted] blob byte length from the data commitment
    shard_block_length = body_summary.commitment.samples_count * BYTES_PER_SAMPLE
    transition_chunks = (shard_block_length + BYTES_PER_CUSTODY_CHUNK - 1) // BYTES_PER_CUSTODY_CHUNK
    assert challenge.chunk_index < transition_chunks
    # Add new chunk challenge record
    new_record = CustodyChunkChallengeRecord(
        challenge_index=state.custody_chunk_challenge_index,
        challenger_index=get_beacon_proposer_index(state),
        responder_index=challenge.responder_index,
        inclusion_epoch=get_current_epoch(state),
        data_root=data_root,
        chunk_index=challenge.chunk_index,
    )
    replace_empty_or_append(state.custody_chunk_challenge_records, new_record)

    state.custody_chunk_challenge_index += 1
    # Postpone responder withdrawability
    responder.withdrawable_epoch = FAR_FUTURE_EPOCH


def process_chunk_challenge_response(state: BeaconState,
                                     response: CustodyChunkResponse) -> None:
    # Get matching challenge (if any) from records
    matching_challenges = [
        record for record in state.custody_chunk_challenge_records
        if record.challenge_index == response.challenge_index
    ]
    assert len(matching_challenges) == 1
    challenge = matching_challenges[0]
    # Verify chunk index
    assert response.chunk_index == challenge.chunk_index
    # Verify the chunk matches the crosslink data root
    assert is_valid_merkle_branch(
        leaf=hash_tree_root(response.chunk),
        branch=response.branch,
        depth=CUSTODY_RESPONSE_DEPTH + 1,  # Add 1 for the length mix-in
        index=response.chunk_index,
        root=challenge.data_root,
    )
    # Clear the challenge
    index_in_records = list(state.custody_chunk_challenge_records).index(challenge)
    state.custody_chunk_challenge_records[index_in_records] = CustodyChunkChallengeRecord()
    # Reward the proposer
    proposer_index = get_beacon_proposer_index(state)
    increase_balance(state, proposer_index, Gwei(get_base_reward(state, proposer_index) // MINOR_REWARD_QUOTIENT))


def process_custody_key_reveal(state: BeaconState, reveal: CustodyKeyReveal) -> None:
    """
    Process ``CustodyKeyReveal`` operation.
    Note that this function mutates ``state``.
    """
    revealer = state.validators[reveal.revealer_index]
    epoch_to_sign = get_randao_epoch_for_custody_period(revealer.next_custody_secret_to_reveal, reveal.revealer_index)

    custody_reveal_period = get_custody_period_for_validator(reveal.revealer_index, get_current_epoch(state))
    # Only past custody periods can be revealed, except after exiting the exit period can be revealed
    is_past_reveal = revealer.next_custody_secret_to_reveal < custody_reveal_period
    is_exited = revealer.exit_epoch <= get_current_epoch(state)
    is_exit_period_reveal = (
        revealer.next_custody_secret_to_reveal
        == get_custody_period_for_validator(reveal.revealer_index, revealer.exit_epoch - 1)
    )
    assert is_past_reveal or (is_exited and is_exit_period_reveal)

    # Revealed validator is active or exited, but not withdrawn
    assert is_slashable_validator(revealer, get_current_epoch(state))

    # Verify signature
    domain = get_domain(state, DOMAIN_RANDAO, epoch_to_sign)
    signing_root = compute_signing_root(epoch_to_sign, domain)
    assert bls.Verify(revealer.pubkey, signing_root, reveal.reveal)

    # Process reveal
    if is_exited and is_exit_period_reveal:
        revealer.all_custody_secrets_revealed_epoch = get_current_epoch(state)
    revealer.next_custody_secret_to_reveal += 1

    # Reward Block Proposer
    proposer_index = get_beacon_proposer_index(state)
    increase_balance(
        state,
        proposer_index,
        Gwei(get_base_reward(state, reveal.revealer_index) // MINOR_REWARD_QUOTIENT)
    )


def process_early_derived_secret_reveal(state: BeaconState, reveal: EarlyDerivedSecretReveal) -> None:
    """
    Process ``EarlyDerivedSecretReveal`` operation.
    Note that this function mutates ``state``.
    """
    revealed_validator = state.validators[reveal.revealed_index]
    derived_secret_location = uint64(reveal.epoch % EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS)

    assert reveal.epoch >= get_current_epoch(state) + RANDAO_PENALTY_EPOCHS
    assert reveal.epoch < get_current_epoch(state) + EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS
    assert not revealed_validator.slashed
    assert reveal.revealed_index not in state.exposed_derived_secrets[derived_secret_location]

    # Verify signature correctness
    masker = state.validators[reveal.masker_index]
    pubkeys = [revealed_validator.pubkey, masker.pubkey]

    domain = get_domain(state, DOMAIN_RANDAO, reveal.epoch)
    signing_roots = [compute_signing_root(root, domain) for root in [hash_tree_root(reveal.epoch), reveal.mask]]
    assert bls.AggregateVerify(pubkeys, signing_roots, reveal.reveal)

    if reveal.epoch >= get_current_epoch(state) + CUSTODY_PERIOD_TO_RANDAO_PADDING:
        # Full slashing when the secret was revealed so early it may be a valid custody
        # round key
        slash_validator(state, reveal.revealed_index, reveal.masker_index)
    else:
        # Only a small penalty proportional to proposer slot reward for RANDAO reveal
        # that does not interfere with the custody period
        # The penalty is proportional to the max proposer reward

        # Calculate penalty
        max_proposer_slot_reward = (
            get_base_reward(state, reveal.revealed_index)
            * SLOTS_PER_EPOCH
            // len(get_active_validator_indices(state, get_current_epoch(state)))
            // PROPOSER_REWARD_QUOTIENT
        )
        penalty = Gwei(
            max_proposer_slot_reward
            * EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE
            * (len(state.exposed_derived_secrets[derived_secret_location]) + 1)
        )

        # Apply penalty
        proposer_index = get_beacon_proposer_index(state)
        whistleblower_index = reveal.masker_index
        whistleblowing_reward = Gwei(penalty // WHISTLEBLOWER_REWARD_QUOTIENT)
        proposer_reward = Gwei(whistleblowing_reward // PROPOSER_REWARD_QUOTIENT)
        increase_balance(state, proposer_index, proposer_reward)
        increase_balance(state, whistleblower_index, whistleblowing_reward - proposer_reward)
        decrease_balance(state, reveal.revealed_index, penalty)

        # Mark this derived secret as exposed so validator cannot be punished repeatedly
        state.exposed_derived_secrets[derived_secret_location].append(reveal.revealed_index)


def process_custody_slashing(state: BeaconState, signed_custody_slashing: SignedCustodySlashing) -> None:
    custody_slashing = signed_custody_slashing.message
    attestation = custody_slashing.attestation

    # Any signed custody-slashing should result in at least one slashing.
    # If the custody bits are valid, then the claim itself is slashed.
    malefactor = state.validators[custody_slashing.malefactor_index]
    whistleblower = state.validators[custody_slashing.whistleblower_index]
    domain = get_domain(state, DOMAIN_CUSTODY_BIT_SLASHING, get_current_epoch(state))
    signing_root = compute_signing_root(custody_slashing, domain)
    assert bls.Verify(whistleblower.pubkey, signing_root, signed_custody_slashing.signature)
    # Verify that the whistleblower is slashable
    assert is_slashable_validator(whistleblower, get_current_epoch(state))
    # Verify that the claimed malefactor is slashable
    assert is_slashable_validator(malefactor, get_current_epoch(state))

    # Verify the attestation
    assert is_valid_indexed_attestation(state, get_indexed_attestation(state, attestation))

    # [Adapted] Verify the blob header is indeed attested by the attestation
    assert hash_tree_root(custody_slashing.shard_blob_header) == attestation.data.shard_blob_root
    body_summary = custody_slashing.shard_blob_header.body_summary
    # Verify that the provided data matches the commitment's byte length and
    # the custody view of the data root
    assert len(custody_slashing.data) == body_summary.commitment.samples_count * BYTES_PER_SAMPLE
    assert compute_custody_data_root(custody_slashing.data) == body_summary.data_root
    # Verify existence and participation of claimed malefactor
    attesters = get_attesting_indices(state, attestation.data, attestation.aggregation_bits)
    assert custody_slashing.malefactor_index in attesters

    # Verify the malefactor custody key
    epoch_to_sign = get_randao_epoch_for_custody_period(
        get_custody_period_for_validator(custody_slashing.malefactor_index, attestation.data.target.epoch),
        custody_slashing.malefactor_index,
    )
    domain = get_domain(state, DOMAIN_RANDAO, epoch_to_sign)
    signing_root = compute_signing_root(epoch_to_sign, domain)
    assert bls.Verify(malefactor.pubkey, signing_root, custody_slashing.malefactor_secret)

    # Compute the custody bit
    computed_custody_bit = compute_custody_bit(custody_slashing.malefactor_secret, custody_slashing.data)

    # Verify the claim
    if computed_custody_bit == 1:
        # Slash the malefactor, reward the other committee members
        slash_validator(state, custody_slashing.malefactor_index)
        committee = get_beacon_committee(state, attestation.data.slot, attestation.data.index)
        others_count = len(committee) - 1
        whistleblower_reward = Gwei(malefactor.effective_balance // WHISTLEBLOWER_REWARD_QUOTIENT // others_count)
        for attester_index in attesters:
            if attester_index != custody_slashing.malefactor_index:
                increase_balance(state, attester_index, whistleblower_reward)
        # No special whisteblower reward: it is expected to be an attester. Others are free to slash too however.
    else:
        # The claim was false, the custody bit was correct. Slash the whistleblower that induced this work.
        slash_validator(state, custody_slashing.whistleblower_index)


# ---------------------------------------------------------------------------
# epoch transition (custody_game/beacon-chain.md:612-706)
# ---------------------------------------------------------------------------

# [Adapted] the draft text overrides a stale phase0-era epoch pipeline and
# references sharding passes by their old names; this extends the CURRENT
# sharding process_epoch, inserting the custody passes at the spec's points:
# deadlines between registry updates and slashings, final updates at the end
def process_epoch(state: BeaconState) -> None:
    # Sharding pre-processing
    process_pending_shard_confirmations(state)
    reset_pending_shard_work(state)

    # Base functionality
    process_justification_and_finalization(state)
    process_inactivity_updates(state)
    process_rewards_and_penalties(state)
    process_registry_updates(state)

    # Proof of custody
    process_reveal_deadlines(state)
    process_challenge_deadlines(state)

    process_slashings(state)

    # Final updates
    process_eth1_data_reset(state)
    process_effective_balance_updates(state)
    process_slashings_reset(state)
    process_randao_mixes_reset(state)
    process_historical_roots_update(state)
    process_participation_flag_updates(state)
    process_sync_committee_updates(state)
    # Proof of custody
    process_custody_final_updates(state)


def process_reveal_deadlines(state: BeaconState) -> None:
    epoch = get_current_epoch(state)
    for index, validator in enumerate(state.validators):
        deadline = validator.next_custody_secret_to_reveal + 1
        if get_custody_period_for_validator(ValidatorIndex(index), epoch) > deadline:
            slash_validator(state, ValidatorIndex(index))


def process_challenge_deadlines(state: BeaconState) -> None:
    for custody_chunk_challenge in state.custody_chunk_challenge_records:
        if get_current_epoch(state) > custody_chunk_challenge.inclusion_epoch + EPOCHS_PER_CUSTODY_PERIOD:
            slash_validator(state, custody_chunk_challenge.responder_index, custody_chunk_challenge.challenger_index)
            index_in_records = list(state.custody_chunk_challenge_records).index(custody_chunk_challenge)
            state.custody_chunk_challenge_records[index_in_records] = CustodyChunkChallengeRecord()


def process_custody_final_updates(state: BeaconState) -> None:
    # Clean up exposed RANDAO key reveals
    state.exposed_derived_secrets[get_current_epoch(state) % EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS] = []

    # Reset withdrawable epochs if challenge records are empty
    records = state.custody_chunk_challenge_records
    validator_indices_in_records = set(record.responder_index for record in records)  # non-duplicate
    for index, validator in enumerate(state.validators):
        if validator.exit_epoch != FAR_FUTURE_EPOCH:
            not_all_secrets_are_revealed = validator.all_custody_secrets_revealed_epoch == FAR_FUTURE_EPOCH
            if ValidatorIndex(index) in validator_indices_in_records or not_all_secrets_are_revealed:
                # Delay withdrawable epochs if challenge records are not empty or not all
                # custody secrets revealed
                validator.withdrawable_epoch = FAR_FUTURE_EPOCH
            else:
                # Reset withdrawable epochs if challenge records are empty and all secrets are revealed
                if validator.withdrawable_epoch == FAR_FUTURE_EPOCH:
                    validator.withdrawable_epoch = Epoch(validator.all_custody_secrets_revealed_epoch
                                                         + config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)
