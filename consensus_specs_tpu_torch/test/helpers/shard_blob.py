"""Builders for sharding-draft shard blob headers (original; the reference's
helpers/shard_block.py targets an older incompatible draft and is dead code
there — see reference specs/sharding/beacon-chain.md for the current one).

Data is treated as the coefficient vector of the committed polynomial, so
`deg(B) < samples_count * POINTS_PER_SAMPLE` holds by construction and the
degree proof is the shifted commitment the spec describes
(reference specs/sharding/beacon-chain.md:746-751).
"""
from ...utils import bls
from ...utils import kzg
from ...utils.bls12_381 import g1_to_bytes
from .keys import privkeys


def builder_privkey(builder_index: int):
    """Genesis installs builder i with pubkeys[-(1+i)] (helpers/genesis.py)."""
    return privkeys[-(1 + int(builder_index))]


def get_sample_blob_data(spec, samples_count: int, seed: int = 7):
    n = int(samples_count) * int(spec.POINTS_PER_SAMPLE)
    modulus = int(spec.MODULUS)
    return [(seed * (i + 1) * 0x9E3779B97F4A7C15 + i) % modulus for i in range(n)]


def build_data_commitment(spec, data):
    """(DataCommitment, degree_proof bytes) for coefficient-form ``data``."""
    setup = kzg.lazy_setup(int(spec.KZG_SETUP_TAU), int(spec.KZG_SETUP_SIZE))
    coeffs = [int(d) for d in data]
    samples_count = len(coeffs) // int(spec.POINTS_PER_SAMPLE)
    point = kzg.commit_to_poly(setup, coeffs)
    proof = kzg.degree_proof(setup, coeffs, len(coeffs))
    commitment = spec.DataCommitment(
        point=spec.BLSCommitment(g1_to_bytes(point)),
        samples_count=samples_count,
    )
    return commitment, spec.BLSCommitment(g1_to_bytes(proof))


def sign_shard_blob_header(spec, state, header, builder_index=None, proposer_index=None):
    """Builder+proposer aggregate signature over the header
    (reference specs/sharding/beacon-chain.md:706-710)."""
    if builder_index is None:
        builder_index = header.builder_index
    if proposer_index is None:
        proposer_index = header.proposer_index
    signing_root = spec.compute_signing_root(
        header, spec.get_domain(state, spec.DOMAIN_SHARD_BLOB)
    )
    sigs = [
        bls.Sign(builder_privkey(builder_index), signing_root),
        bls.Sign(privkeys[int(proposer_index)], signing_root),
    ]
    return spec.SignedShardBlobHeader(message=header, signature=bls.Aggregate(sigs))


def build_shard_blob_header(spec, state, slot=None, shard=0, samples_count=1,
                            builder_index=0, max_fee_per_sample=None,
                            max_priority_fee_per_sample=0, signed=True,
                            data_seed=7):
    """A processable SignedShardBlobHeader for (slot, shard): real KZG
    commitment + degree proof, correct shard proposer, fees covering the
    current sample price. Distinct ``data_seed`` values give distinct
    headers (distinct commitments and roots)."""
    if slot is None:
        slot = state.slot
    slot = spec.Slot(slot)
    shard = spec.Shard(shard)
    data = get_sample_blob_data(spec, samples_count, seed=data_seed)
    commitment, degree_proof = build_data_commitment(spec, data)
    if max_fee_per_sample is None:
        max_fee_per_sample = state.shard_sample_price
    body_summary = spec.ShardBlobBodySummary(
        commitment=commitment,
        degree_proof=degree_proof,
        data_root=spec.hash_tree_root(
            spec.List[spec.BLSPoint, spec.POINTS_PER_SAMPLE * spec.MAX_SAMPLES_PER_BLOB](
                *[spec.BLSPoint(d) for d in data]
            )
        ),
        max_priority_fee_per_sample=max_priority_fee_per_sample,
        max_fee_per_sample=max_fee_per_sample,
    )
    header = spec.ShardBlobHeader(
        slot=slot,
        shard=shard,
        builder_index=builder_index,
        proposer_index=spec.get_shard_proposer_index(state, slot, shard),
        body_summary=body_summary,
    )
    if signed:
        return sign_shard_blob_header(spec, state, header)
    return spec.SignedShardBlobHeader(message=header)


def build_shard_proposer_slashing(spec, state, slot=None, shard=0,
                                  builder_index_1=0, builder_index_2=1,
                                  proposer_index=None, signed=True):
    """Two conflicting shard-blob references co-signed by the same proposer
    (reference specs/sharding/beacon-chain.md:771-806)."""
    if slot is None:
        slot = state.slot
    slot = spec.Slot(slot)
    shard = spec.Shard(shard)
    if proposer_index is None:
        proposer_index = spec.get_shard_proposer_index(state, slot, shard)
    body_root_1 = spec.hash_tree_root(spec.ShardBlobBody())
    body_root_2 = spec.hash_tree_root(
        spec.ShardBlobBody(max_fee_per_sample=spec.Gwei(1))
    )
    domain = spec.get_domain(
        state, spec.DOMAIN_SHARD_PROPOSER, spec.compute_epoch_at_slot(slot)
    )

    def _sig(builder_index, body_root):
        reference = spec.ShardBlobReference(
            slot=slot, shard=shard,
            proposer_index=proposer_index,
            builder_index=builder_index,
            body_root=body_root,
        )
        signing_root = spec.compute_signing_root(reference, domain)
        return bls.Aggregate([
            bls.Sign(builder_privkey(builder_index), signing_root),
            bls.Sign(privkeys[int(proposer_index)], signing_root),
        ])

    return spec.ShardProposerSlashing(
        slot=slot, shard=shard,
        proposer_index=proposer_index,
        builder_index_1=builder_index_1,
        builder_index_2=builder_index_2,
        body_root_1=body_root_1,
        body_root_2=body_root_2,
        signature_1=_sig(builder_index_1, body_root_1) if signed else spec.BLSSignature(),
        signature_2=_sig(builder_index_2, body_root_2) if signed else spec.BLSSignature(),
    )
