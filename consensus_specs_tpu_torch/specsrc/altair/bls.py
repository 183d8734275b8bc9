# Altair — BLS extensions (executable spec source)
#
# Capability parity with reference specs/altair/bls.md (cites into
# the reference consensus-specs). Exec'd into the altair module namespace after phase0's
# sources; the builder swaps eth_aggregate_pubkeys for the backend fast path
# at build time (mirroring reference setup.py:60-63, 484-487).

# (bls.md:26-28)
G2_POINT_AT_INFINITY = BLSSignature(b'\xc0' + b'\x00' * 95)


def eth_aggregate_pubkeys(pubkeys: Sequence[BLSPubkey]) -> BLSPubkey:
    """
    Return the aggregate public key for the public keys in ``pubkeys``.
    (bls.md:33-57; the ``+`` is elliptic-curve point addition over decoded
    pubkeys — the spec-text version defers to the switchboard's AggregatePKs,
    which performs the decode/add/encode round-trip.)
    """
    assert len(pubkeys) > 0
    # Ensure that the given inputs are valid pubkeys
    assert all(bls.KeyValidate(pubkey) for pubkey in pubkeys)
    return BLSPubkey(bls.AggregatePKs(list(pubkeys)))


def eth_fast_aggregate_verify(pubkeys: Sequence[BLSPubkey], message: Bytes32, signature: BLSSignature) -> bool:
    """
    Wrapper to ``bls.FastAggregateVerify`` accepting the ``G2_POINT_AT_INFINITY`` signature when ``pubkeys`` is empty.
    (bls.md:59-68)
    """
    if len(pubkeys) == 0 and signature == G2_POINT_AT_INFINITY:
        return True
    return bls.FastAggregateVerify(pubkeys, message, signature)
