"""The port's copy of the JAX package's utils/das.py.

DAS sampling: split extended blob data into KZG-proven samples, verify
them individually, reconstruct from any half (reference
specs/das/das-core.md:113-190; draft containers :48-56).

Own implementation over utils/kzg.py. A "sample" here is the draft's
``DASSample`` payload as plain data — (index, proof, points) — since the
draft fork itself is not an executable spec in the reference either.

The verify path is the device-relevant one: every sample check is one pairing
product (check_multi_kzg_proof), so a block's worth of samples batches onto
the device exactly like attestation signatures (SURVEY §2.7/P6).
"""
from typing import List, NamedTuple, Optional, Sequence

from . import kzg
from .kzg import MODULUS


class DASSample(NamedTuple):
    index: int
    proof: object  # G1 point (oracle representation)
    data: List[int]  # POINTS_PER_SAMPLE field elements, extended-data order


def sample_data(setup: kzg.Setup, extended_data: Sequence[int],
                points_per_sample: int) -> List[DASSample]:
    """Samples with per-coset multiproofs (das-core.md:128-151)."""
    n = len(extended_data)
    sample_count = n // points_per_sample
    assert sample_count * points_per_sample == n
    # polynomial of the extended data (second half of coefficients zero)
    poly = kzg.inverse_fft(kzg.reverse_bit_order_list(list(extended_data)))
    assert all(c == 0 for c in poly[n // 2:])

    samples = []
    for i in range(sample_count):
        x = _sample_x(n, sample_count, i)
        data = list(extended_data[i * points_per_sample:(i + 1) * points_per_sample])
        proof, ys = kzg.prove_coset(setup, poly, x, points_per_sample)
        # the coset evaluations are exactly the reverse-bit-ordered sample
        assert ys == kzg.reverse_bit_order_list(data)
        samples.append(DASSample(index=i, proof=proof, data=data))
    return samples


def _sample_x(n: int, sample_count: int, index: int) -> int:
    """Coset anchor for sample ``index``.

    Positions [index*pps, (index+1)*pps) of the extended data evaluate the
    polynomial at omega^rbo(index*pps + j, n); writing the n-bit index as
    (index bits | j bits), bit reversal gives exponents
    {rbo(index, sample_count) + k*sample_count}, i.e. the coset of the
    order-pps subgroup anchored at omega^rbo(index, sample_count). (The
    draft's prose here is self-inconsistent — it is marked WIP — so the
    anchor is derived from the ordering actually used by extend_data.)"""
    omega = kzg.root_of_unity(n)
    return pow(omega, kzg.reverse_bit_order(index, sample_count), MODULUS)


def verify_sample(setup: kzg.Setup, sample: DASSample, sample_count: int,
                  commitment) -> bool:
    # (das-core.md:153-162)
    if not 0 <= sample.index < sample_count:
        return False  # reverse_bit_order would alias out-of-range indices
    n = sample_count * len(sample.data)
    x = _sample_x(n, sample_count, sample.index)
    ys = kzg.reverse_bit_order_list(list(sample.data))
    return kzg.check_multi_kzg_proof(setup, commitment, sample.proof, x, ys)


def reconstruct_extended_data(
    samples: Sequence[Optional[DASSample]], sample_count: int,
    points_per_sample: int,
) -> List[int]:
    """Recover the full extended data from >= half the samples
    (das-core.md:164-171)."""
    slots: List[Optional[List[int]]] = [None] * sample_count
    for s in samples:
        if s is not None:
            assert 0 <= s.index < sample_count, "sample index out of range"
            slots[s.index] = list(s.data)
    n = sample_count * points_per_sample
    # map each known point to its NATURAL domain position, recover at the
    # point level (sample boundaries don't align with natural-order chunks),
    # then undo the ordering
    rbo_known: List[Optional[int]] = [None] * n
    for i, sub in enumerate(slots):
        if sub is not None:
            for j, y in enumerate(sub):
                rbo_known[kzg.reverse_bit_order(i * points_per_sample + j, n)] = y
    recovered_natural = kzg.recover_data_points(rbo_known)
    return [recovered_natural[kzg.reverse_bit_order(i, n)] for i in range(n)]
