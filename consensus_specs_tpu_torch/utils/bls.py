"""BLS switchboard of the port: the IETF BLS signature API with a
backend switch, the counterpart of consensus_specs_tpu/utils/bls.py.

Backends:

- "gpu":     the default: the port's batched backend,
             ``ops/bls_backend.py``, on the CUDA card (the counterpart of
             the JAX package's "tpu"). The card is resolved on the first
             verify call, or by ``use_gpu()``; both raise where there is
             none, so no verdict is ever a swallowed missing-device error;
- "py_ecc":  the pure-Python oracle in ``utils/bls12_381.py`` on the CPU,
             selected by ``use_py_ecc()`` (the reference's backend name,
             kept for API parity);
- "milagro": an alias of the oracle (kept so ``use_milagro()`` call sites
             keep working).

The verify functions keep the reference's contract: any exception of the
verification is a False verdict (reference utils/bls.py:47-74), and with
``bls_active`` off they return True without any crypto. The
``oracle_*`` functions are the pure-Python verifications alone, whatever
the switch says: the serve plane's last rung calls them, as do the
point helpers (``pubkey_to_G1``, ``signature_to_G2``) and the pairings
(``pairing_check``, ``Pairing``) the spec's draft forks use. Ciphersuite:
BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_.
"""
from typing import Sequence

from ..device import resolve_device
from .bls12_381 import (
    G1_GEN,
    G2_X0,
    G2_X1,
    G2_Y0,
    G2_Y1,
    R,
    Fq12,
    ec_add,
    ec_from_affine,
    ec_mul,
    ec_neg,
    ec_to_affine,
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    g2_to_bytes,
    hash_to_g2,
    is_in_g1_subgroup,
    is_in_g2_subgroup,
    multi_pairing,
    pairing,
)

bls_active = True
_backend = None  # the card, resolved on first use

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48
G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95
STUB_COORDINATES = ((G2_X0, G2_X1), (G2_Y0, G2_Y1))


def use_py_ecc():
    global _backend
    _backend = "py_ecc"


def use_milagro():
    # API-parity alias: there is no milagro binding; the oracle serves —
    # warn so callers don't believe they got a fast path
    import warnings

    warnings.warn(
        "use_milagro(): no milagro binding in this build; using the "
        "pure-python oracle (use_gpu() selects the fast backend)",
        stacklevel=2,
    )
    global _backend
    _backend = "py_ecc"


def use_gpu():
    """Dispatch the verify functions to ``ops/bls_backend`` on the CUDA
    card. Raises where there is none, so no verdict is ever a swallowed
    missing-device error."""
    global _backend
    resolve_device(None)
    _backend = "gpu"


def backend_name() -> str:
    return _backend or "gpu"


def _on_card() -> bool:
    """True when the verify functions go to the card. Resolves the
    default backend on first use, outside the verdict's exception
    contract: without a card this raises instead of answering False."""
    global _backend
    if _backend is None:
        resolve_device(None)
        _backend = "gpu"
    return _backend == "gpu"


def only_with_bls(alt_return=None):
    """Decorator: skip the BLS op (returning alt_return) when bls_active is
    off (reference: utils/bls.py:33-44)."""

    def decorator(fn):
        def wrapper(*args, **kwargs):
            if not bls_active:
                return alt_return
            return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        return wrapper

    return decorator


# ---------------------------------------------------------------------------
# point helpers (also used by the spec's custody-game crypto); pure-Python
# oracle functions whatever the backend switch says
# ---------------------------------------------------------------------------


def pubkey_to_G1(pubkey: bytes):
    return g1_from_bytes(bytes(pubkey))


def signature_to_G2(signature: bytes):
    """Decompress a signature into G2 affine coordinate integers
    (((x_c0, x_c1), (y_c0, y_c1))), None for infinity."""
    aff = g2_from_bytes(bytes(signature))
    if aff is None:
        return None
    x, y = aff
    return ((x.c0, x.c1), (y.c0, y.c1))


def _gpu_backend():
    from ..ops import bls_backend

    return bls_backend


def _key_validate_point(pubkey: bytes):
    """KeyValidate: valid encoding, not infinity, in the G1 subgroup.
    Returns the affine point; raises on failure."""
    aff = g1_from_bytes(bytes(pubkey))
    if aff is None:
        raise ValueError("pubkey is the point at infinity")
    if not is_in_g1_subgroup(ec_from_affine(aff)):
        raise ValueError("pubkey not in G1 subgroup")
    return aff


def KeyValidate(pubkey: bytes) -> bool:
    try:
        _key_validate_point(pubkey)
        return True
    except ValueError:
        return False


def _sig_to_checked_point(signature: bytes):
    aff = g2_from_bytes(bytes(signature))
    if aff is None:
        raise ValueError("signature is the point at infinity")
    if not is_in_g2_subgroup(ec_from_affine(aff)):
        raise ValueError("signature not in G2 subgroup")
    return aff


def _core_verify(pk_aff, message: bytes, sig_aff) -> bool:
    """e(PK, H(m)) == e(g1, sig), as prod e(PK, H(m)) * e(-g1, sig) == 1."""
    h = ec_to_affine(hash_to_g2(bytes(message), DST))
    neg_gen = ec_to_affine(ec_neg(G1_GEN))
    return multi_pairing([(pk_aff, h), (neg_gen, sig_aff)]) == Fq12.one()


def oracle_verify(PK: bytes, message: bytes, signature: bytes) -> bool:
    try:
        pk_aff = _key_validate_point(PK)
        sig_aff = _sig_to_checked_point(signature)
        return _core_verify(pk_aff, bytes(message), sig_aff)
    except Exception:
        return False


def oracle_aggregate_verify(pubkeys: Sequence[bytes],
                            messages: Sequence[bytes],
                            signature: bytes) -> bool:
    try:
        if len(pubkeys) == 0 or len(pubkeys) != len(messages):
            return False
        sig_aff = _sig_to_checked_point(signature)
        pairs = []
        for pk, msg in zip(pubkeys, messages):
            pk_aff = _key_validate_point(pk)
            h = ec_to_affine(hash_to_g2(bytes(msg), DST))
            pairs.append((pk_aff, h))
        neg_gen = ec_to_affine(ec_neg(G1_GEN))
        pairs.append((neg_gen, sig_aff))
        return multi_pairing(pairs) == Fq12.one()
    except Exception:
        return False


def oracle_fast_aggregate_verify(pubkeys: Sequence[bytes], message: bytes,
                                 signature: bytes) -> bool:
    try:
        if len(pubkeys) == 0:
            return False
        agg = None
        for pk in pubkeys:
            agg = ec_add(agg, ec_from_affine(_key_validate_point(pk)))
        if agg is None:
            return False
        sig_aff = _sig_to_checked_point(signature)
        return _core_verify(ec_to_affine(agg), bytes(message), sig_aff)
    except Exception:
        return False


@only_with_bls(alt_return=True)
def Verify(PK: bytes, message: bytes, signature: bytes) -> bool:
    if not _on_card():
        return oracle_verify(PK, message, signature)
    try:
        return _gpu_backend().verify(PK, message, signature)
    except Exception:
        return False


@only_with_bls(alt_return=True)
def AggregateVerify(pubkeys: Sequence[bytes], messages: Sequence[bytes],
                    signature: bytes) -> bool:
    if not _on_card():
        return oracle_aggregate_verify(pubkeys, messages, signature)
    try:
        if len(pubkeys) == 0 or len(pubkeys) != len(messages):
            return False
        return _gpu_backend().aggregate_verify(pubkeys, messages, signature)
    except Exception:
        return False


@only_with_bls(alt_return=True)
def FastAggregateVerify(pubkeys: Sequence[bytes], message: bytes,
                        signature: bytes) -> bool:
    if not _on_card():
        return oracle_fast_aggregate_verify(pubkeys, message, signature)
    try:
        if len(pubkeys) == 0:
            return False
        return _gpu_backend().fast_aggregate_verify(pubkeys, message,
                                                    signature)
    except Exception:
        return False


@only_with_bls(alt_return=STUB_SIGNATURE)
def Aggregate(signatures: Sequence[bytes]) -> bytes:
    if len(signatures) == 0:
        raise ValueError("Aggregate requires at least one signature")
    acc = None
    for sig in signatures:
        aff = g2_from_bytes(bytes(sig))
        acc = ec_add(acc, ec_from_affine(aff) if aff is not None else None)
    return g2_to_bytes(ec_to_affine(acc))


@only_with_bls(alt_return=STUB_SIGNATURE)
def Sign(SK: int, message: bytes) -> bytes:
    sk = int(SK)
    if not 0 < sk < R:
        raise ValueError("invalid secret key")
    h = hash_to_g2(bytes(message), DST)
    return g2_to_bytes(ec_to_affine(ec_mul(h, sk)))


@only_with_bls(alt_return=STUB_PUBKEY)
def SkToPk(SK: int) -> bytes:
    sk = int(SK)
    if not 0 < sk < R:
        raise ValueError("invalid secret key")
    return g1_to_bytes(ec_to_affine(ec_mul(G1_GEN, sk)))


@only_with_bls(alt_return=STUB_PUBKEY)
def AggregatePKs(pubkeys: Sequence[bytes]) -> bytes:
    """Aggregate public keys with per-key KeyValidate
    (reference: utils/bls.py:95-103)."""
    if len(pubkeys) == 0:
        raise ValueError("AggregatePKs requires at least one pubkey")
    acc = None
    for pk in pubkeys:
        acc = ec_add(acc, ec_from_affine(_key_validate_point(pk)))
    return g1_to_bytes(ec_to_affine(acc))


@only_with_bls(alt_return=True)
def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 over (G1 affine, G2 affine) pairs: the
    sharding spec's KZG degree checks."""
    return multi_pairing(pairs) == Fq12.one()


@only_with_bls(alt_return=None)
def Pairing(p, q):
    """e(P, Q) as a comparable GT element (the sharding draft's
    ``process_shard_header`` compares two pairings). Accepts G1 as
    compressed Bytes48 or a curve point, G2 as compressed Bytes96 or a
    curve point."""
    if isinstance(p, (bytes, bytearray)):
        p_aff = g1_from_bytes(bytes(p))
    else:
        p_aff = p if (p is None or len(p) == 2) else ec_to_affine(p)
    if isinstance(q, (bytes, bytearray)):
        q_aff = g2_from_bytes(bytes(q))
    else:
        q_aff = q if (q is None or len(q) == 2) else ec_to_affine(q)
    return pairing(q_aff, p_aff)
