"""The port's copy of the JAX package's utils/custody.py, over the
port's switchboard.

Custody-game cryptographic primitives (draft fork support).

Own implementation with capability parity to the crypto core of reference
specs/custody_game/beacon-chain.md:258-335: the Legendre-symbol custody
bit over a universal hash of 32-byte data atoms keyed by secrets extracted
from a BLS signature. These are the computable parts the draft's
challenge/response machinery consumes; the epoch-processing scaffolding of
the draft fork follows once the fork is promoted from draft.

The Legendre evaluation over a batch of atoms is an embarrassingly parallel
modular-arithmetic sweep — the same device plane as the field VM if the
custody fork ever needs throughput.
"""
from typing import List, Sequence

from . import bls

# draft constants (custody_game/beacon-chain.md constant tables)
BYTES_PER_CUSTODY_ATOM = 32
CUSTODY_PRIME = 2**256 - 189
CUSTODY_SECRETS = 3
CUSTODY_PROBABILITY_EXPONENT = 10
EPOCHS_PER_CUSTODY_PERIOD = 2**14
CUSTODY_PERIOD_TO_RANDAO_PADDING = 2**11


def legendre_bit(a: int, q: int) -> int:
    """(a/q) Legendre symbol normalized to a bit, via iterative quadratic
    reciprocity (no exponentiation — the draft's prescribed shape)."""
    a %= q
    if a == 0:
        return 0
    assert q > a > 0 and q % 2 == 1
    t = 1
    n = q
    while a != 0:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                t = -t
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            t = -t
        a %= n
    return (t + 1) // 2 if n == 1 else 0


def get_custody_atoms(bytez: bytes) -> List[bytes]:
    """Right-pad to a whole number of 32-byte atoms and split."""
    pad = (BYTES_PER_CUSTODY_ATOM - len(bytez) % BYTES_PER_CUSTODY_ATOM) % BYTES_PER_CUSTODY_ATOM
    padded = bytes(bytez) + b"\x00" * pad
    return [
        padded[i:i + BYTES_PER_CUSTODY_ATOM]
        for i in range(0, len(padded), BYTES_PER_CUSTODY_ATOM)
    ]


def get_custody_secrets(key: bytes) -> List[int]:
    """Secrets from the x-coordinate of the signature's G2 point: the two
    48-byte Fq2 limbs little-endian-joined, re-chunked into 32-byte ints."""
    ((x_c0, x_c1), _y) = bls.signature_to_G2(key)
    signature_bytes = x_c0.to_bytes(48, "little") + x_c1.to_bytes(48, "little")
    return [
        int.from_bytes(signature_bytes[i:i + BYTES_PER_CUSTODY_ATOM], "little")
        for i in range(0, len(signature_bytes), 32)
    ]


def universal_hash_function(data_chunks: Sequence[bytes], secrets: Sequence[int]) -> int:
    n = len(data_chunks)
    acc = 0
    for i, atom in enumerate(data_chunks):
        acc += (
            pow(secrets[i % CUSTODY_SECRETS], i, CUSTODY_PRIME)
            * int.from_bytes(atom, "little")
        ) % CUSTODY_PRIME
    return (acc + pow(secrets[n % CUSTODY_SECRETS], n, CUSTODY_PRIME)) % CUSTODY_PRIME


def get_randao_epoch_for_custody_period(period: int, validator_index: int) -> int:
    """Epoch whose randao reveal keys a validator's custody period — each
    validator's period boundary is offset by its index, staggering reveals
    (custody_game/beacon-chain.md:336-341)."""
    next_period_start = (
        (period + 1) * EPOCHS_PER_CUSTODY_PERIOD
        - validator_index % EPOCHS_PER_CUSTODY_PERIOD
    )
    return next_period_start + CUSTODY_PERIOD_TO_RANDAO_PADDING


def get_custody_period_for_validator(validator_index: int, epoch: int) -> int:
    """Reveal period covering ``epoch`` for ``validator_index``
    (custody_game/beacon-chain.md:343-350)."""
    return (
        epoch + validator_index % EPOCHS_PER_CUSTODY_PERIOD
    ) // EPOCHS_PER_CUSTODY_PERIOD


def compute_custody_bit(key: bytes, data: bytes) -> int:
    custody_atoms = get_custody_atoms(data)
    secrets = get_custody_secrets(key)
    uhf = universal_hash_function(custody_atoms, secrets)
    bits = [
        legendre_bit(uhf + secrets[0] + i, CUSTODY_PRIME)
        for i in range(CUSTODY_PROBABILITY_EXPONENT)
    ]
    return int(all(bits))
