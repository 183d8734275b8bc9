"""The port's copy of the JAX package's utils/sharding.py.

Sharding-draft computable parts: the EIP-1559-style sample-price fee
market and committee-lookahead helper, plus the shard-blob commitment check
built on utils/kzg.py.

Provenance: the fee-market and source-epoch bodies are transcribed from the
draft spec text (reference specs/sharding/beacon-chain.md:433-457) —
conformance requires identical arithmetic; the draft fork is not compiled
by the reference either, so these live as library functions the eventual
fork source will exec against. The degree-proof pairing check
(beacon-chain.md:717-721) is utils/kzg.verify_degree_proof.
"""
from typing import Sequence

from . import kzg

# constants (sharding/beacon-chain.md:100-115)
POINTS_PER_SAMPLE = 2**3
SAMPLE_PRICE_ADJUSTMENT_COEFFICIENT = 2**3
MAX_SAMPLES_PER_BLOB = 2**11
TARGET_SAMPLES_PER_BLOB = 2**10
MAX_SAMPLE_PRICE = 2**33
MIN_SAMPLE_PRICE = 2**3
SLOTS_PER_EPOCH = 32  # mainnet protocol constant


def compute_updated_sample_price(prev_price: int, samples_length: int,
                                 active_shards: int) -> int:
    # (sharding/beacon-chain.md:433-444)
    adjustment_quotient = (
        active_shards * SLOTS_PER_EPOCH * SAMPLE_PRICE_ADJUSTMENT_COEFFICIENT
    )
    if samples_length > TARGET_SAMPLES_PER_BLOB:
        delta = max(1, prev_price * (samples_length - TARGET_SAMPLES_PER_BLOB)
                    // TARGET_SAMPLES_PER_BLOB // adjustment_quotient)
        return min(prev_price + delta, MAX_SAMPLE_PRICE)
    else:
        delta = max(1, prev_price * (TARGET_SAMPLES_PER_BLOB - samples_length)
                    // TARGET_SAMPLES_PER_BLOB // adjustment_quotient)
        return max(prev_price, MIN_SAMPLE_PRICE + delta) - delta


def compute_committee_source_epoch(epoch: int, period: int) -> int:
    """Source epoch for committee computation, one period of lookahead
    (sharding/beacon-chain.md:446-457)."""
    source_epoch = epoch - epoch % period
    if source_epoch >= period:
        source_epoch -= period  # `period` epochs lookahead
    return source_epoch


def verify_shard_blob_commitment(setup: kzg.Setup, commitment, degree_proof,
                                 data: Sequence[int]) -> bool:
    """The shard-header acceptance checks over a blob's data
    (sharding/beacon-chain.md:700-721): the commitment matches the data
    polynomial AND the degree proof bounds its length."""
    points_count = len(data)
    from .bls12_381 import ec_eq

    expected = kzg.commit_to_data(setup, data)
    if not ec_eq(expected, commitment):
        return False
    return kzg.verify_degree_proof(setup, commitment, degree_proof, points_count)
