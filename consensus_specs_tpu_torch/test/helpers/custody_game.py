"""Builders for custody-game operations, adapted to this build's executable
sharding layer (ShardBlobHeader/shard_blob_root instead of the reference's
stale ShardTransition — see specsrc/custody_game/beacon_chain.py header).

Construction semantics (reveal = randao-domain signature over the period
epoch; masked early reveal = Aggregate(reveal, masker's mask signature))
follow reference test/helpers/custody.py / the spec's verification rules.
"""
from ...utils import bls
from .attestations import get_valid_attestation
from .keys import privkeys


def get_valid_custody_key_reveal(spec, state, period=None, validator_index=None):
    current_epoch = spec.get_current_epoch(state)
    revealer_index = (spec.get_active_validator_indices(state, current_epoch)[0]
                      if validator_index is None else validator_index)
    revealer = state.validators[revealer_index]

    if period is None:
        period = revealer.next_custody_secret_to_reveal

    epoch_to_sign = spec.get_randao_epoch_for_custody_period(period, revealer_index)

    domain = spec.get_domain(state, spec.DOMAIN_RANDAO, epoch_to_sign)
    signing_root = spec.compute_signing_root(spec.Epoch(epoch_to_sign), domain)
    reveal = bls.Sign(privkeys[int(revealer_index)], signing_root)
    return spec.CustodyKeyReveal(
        revealer_index=revealer_index,
        reveal=reveal,
    )


def get_valid_early_derived_secret_reveal(spec, state, epoch=None):
    current_epoch = spec.get_current_epoch(state)
    revealed_index = spec.get_active_validator_indices(state, current_epoch)[-1]
    masker_index = spec.get_active_validator_indices(state, current_epoch)[0]

    if epoch is None:
        epoch = current_epoch + spec.CUSTODY_PERIOD_TO_RANDAO_PADDING

    # the secret being revealed: the randao-domain signature over the epoch
    domain = spec.get_domain(state, spec.DOMAIN_RANDAO, epoch)
    signing_root = spec.compute_signing_root(spec.Epoch(epoch), domain)
    reveal = bls.Sign(privkeys[int(revealed_index)], signing_root)
    # any mask that doesn't leak the masker's own secret will do
    mask = spec.Bytes32(spec.hash(reveal))
    signing_root = spec.compute_signing_root(mask, domain)
    masker_signature = bls.Sign(privkeys[int(masker_index)], signing_root)
    masked_reveal = bls.Aggregate([reveal, masker_signature])

    return spec.EarlyDerivedSecretReveal(
        revealed_index=revealed_index,
        epoch=epoch,
        reveal=masked_reveal,
        masker_index=masker_index,
        mask=mask,
    )


def get_real_custody_secret(spec, state, validator_index, epoch=None):
    """The validator's actual custody secret. Computed with the BLS switch
    forced on: compute_custody_bit must decode the secret as a G2 point even
    in bls-off test runs, so a stub signature won't do."""
    was_active = bls.bls_active
    bls.bls_active = True
    try:
        return spec.get_custody_secret(
            state, spec.ValidatorIndex(validator_index),
            privkeys[int(validator_index)], epoch,
        )
    finally:
        bls.bls_active = was_active


def get_sample_custody_data(spec, samples_count, seed=3):
    """Blob bytes of exactly samples_count * BYTES_PER_SAMPLE."""
    n = int(samples_count) * int(spec.BYTES_PER_SAMPLE)
    return bytes((seed * 31 + i * 7) % 256 for i in range(n))


def get_shard_blob_header_for_data(spec, state, data, slot=None, shard=0):
    """A ShardBlobHeader whose body_summary commits to ``data`` the custody
    way (data_root = compute_custody_data_root); the KZG point is irrelevant
    to the custody handlers and left empty."""
    if slot is None:
        slot = state.slot
    samples_count = len(data) // int(spec.BYTES_PER_SAMPLE)
    assert samples_count * int(spec.BYTES_PER_SAMPLE) == len(data)
    body_summary = spec.ShardBlobBodySummary(
        commitment=spec.DataCommitment(samples_count=samples_count),
        data_root=spec.compute_custody_data_root(data),
    )
    return spec.ShardBlobHeader(
        slot=spec.Slot(slot),
        shard=spec.Shard(shard),
        builder_index=0,
        proposer_index=spec.get_shard_proposer_index(state, spec.Slot(slot), spec.Shard(shard)),
        body_summary=body_summary,
    )


def get_attestation_for_blob_header(spec, state, header, signed=True):
    """An attestation of the committee for (header.slot, shard->index) voting
    for the header's root. Signed AFTER the shard_blob_root is set so the
    signature stays valid in real-BLS (generator) runs."""
    from .attestations import sign_attestation

    index = spec.compute_committee_index_from_shard(state, header.slot, header.shard)
    attestation = get_valid_attestation(spec, state, slot=header.slot, index=index)
    attestation.data.shard_blob_root = spec.hash_tree_root(header)
    if signed:
        sign_attestation(spec, state, attestation)
    return attestation


def get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=0,
                              responder_index=None):
    if responder_index is None:
        attesters = spec.get_attesting_indices(
            state, attestation.data, attestation.aggregation_bits
        )
        responder_index = sorted(attesters)[0]
    return spec.CustodyChunkChallenge(
        responder_index=responder_index,
        shard_blob_header=header,
        attestation=attestation,
        chunk_index=chunk_index,
    )


def custody_chunk_leaves(spec, data):
    """The leaf layer compute_custody_data_root hashes over."""
    bytez = bytes(data)
    chunk_size = int(spec.BYTES_PER_CUSTODY_CHUNK)
    padded_len = max(1, (len(bytez) + chunk_size - 1) // chunk_size) * chunk_size
    padded = bytez + b'\x00' * (padded_len - len(bytez))
    leaves = [
        spec.hash_tree_root(spec.ByteVector[spec.BYTES_PER_CUSTODY_CHUNK](padded[i:i + chunk_size]))
        for i in range(0, len(padded), chunk_size)
    ]
    leaves += [spec.Bytes32()] * (2 ** int(spec.CUSTODY_RESPONSE_DEPTH) - len(leaves))
    return [bytes(leaf) for leaf in leaves], padded


def get_custody_chunk_branch(spec, data, chunk_index):
    """Merkle branch for chunk_index against compute_custody_data_root(data):
    CUSTODY_RESPONSE_DEPTH tree siblings + the byte-length mix-in node."""
    leaves, _ = custody_chunk_leaves(spec, data)
    branch = []
    nodes = leaves
    index = int(chunk_index)
    for _ in range(int(spec.CUSTODY_RESPONSE_DEPTH)):
        branch.append(nodes[index ^ 1])
        nodes = [spec.hash(nodes[i] + nodes[i + 1]) for i in range(0, len(nodes), 2)]
        index //= 2
    branch.append(len(bytes(data)).to_bytes(32, 'little'))
    return branch


def get_valid_custody_chunk_response(spec, state, challenge_record, data):
    """Response carrying the challenged chunk and its proof."""
    _, padded = custody_chunk_leaves(spec, data)
    chunk_size = int(spec.BYTES_PER_CUSTODY_CHUNK)
    idx = int(challenge_record.chunk_index)
    chunk = padded[idx * chunk_size:(idx + 1) * chunk_size]
    return spec.CustodyChunkResponse(
        challenge_index=challenge_record.challenge_index,
        chunk_index=challenge_record.chunk_index,
        chunk=spec.ByteVector[spec.BYTES_PER_CUSTODY_CHUNK](chunk),
        branch=get_custody_chunk_branch(spec, data, challenge_record.chunk_index),
    )


def get_valid_custody_slashing(spec, state, attestation, header, custody_secret, data,
                               malefactor_index=None, whistleblower_index=None, signed=True):
    attesters = sorted(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ))
    if malefactor_index is None:
        malefactor_index = attesters[0]
    if whistleblower_index is None:
        committee = spec.get_beacon_committee(state, attestation.data.slot, attestation.data.index)
        whistleblower_index = committee[-1]

    slashing = spec.CustodySlashing(
        malefactor_index=malefactor_index,
        malefactor_secret=custody_secret,
        whistleblower_index=whistleblower_index,
        shard_blob_header=header,
        attestation=attestation,
        data=data,
    )
    slashing_domain = spec.get_domain(state, spec.DOMAIN_CUSTODY_BIT_SLASHING)
    slashing_root = spec.compute_signing_root(slashing, slashing_domain)
    return spec.SignedCustodySlashing(
        message=slashing,
        signature=(bls.Sign(privkeys[int(whistleblower_index)], slashing_root)
                   if signed else spec.BLSSignature()),
    )


def find_data_with_custody_bit(spec, custody_secret, samples_count, want_bit, max_tries=4096):
    """Search sample data until compute_custody_bit(key, data) == want_bit —
    bit 1 requires all CUSTODY_PROBABILITY_EXPONENT legendre bits to be 1
    (probability 2**-10 per try), the reference's slashable-vector search."""
    n = int(samples_count) * int(spec.BYTES_PER_SAMPLE)
    for trial in range(max_tries):
        data = bytes((trial >> (8 * (i % 4))) & 0xFF if i < 4 else (i * 11 + trial) % 256
                     for i in range(n))
        if int(spec.compute_custody_bit(custody_secret, data)) == int(want_bit):
            return data
    raise AssertionError(f"no data with custody bit {want_bit} in {max_tries} tries")
