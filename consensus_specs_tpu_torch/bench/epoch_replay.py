"""The epoch of signature checks (BASELINE config 4), built for the port's
``SignatureCollector``: the check set of
consensus_specs_tpu/bench/epoch_replay.py ``build_epoch_checks``, the same
triples for the same shape.

Workload shape (reference protocol constants, BASELINE.md):
  SLOTS x COMMITTEES FastAggregateVerify items of K_att signers each
  (the process_attestation hot loop),
  + SLOTS sync-aggregate verifies of K_sync = 512
  (altair process_sync_aggregate),
  + SLOTS block-proposer verifies of K = 1 (verify_block_signature).

Mainnet is 32 x 64 x 146 over a pool of 512 keys: 2,112 checks and
315,424 signatures. An aggregate of same-message signatures from keys
{sk_i} equals Sign(sum sk_i mod r), so each check costs one signature to
build; with ``pool`` (a ``utils.keygen.KeyPool``) they are built in
spawned processes. Nothing is cached on disk.
"""
from ..batch_verify import SignatureCollector
from ..utils.bls12_381 import R

MAINNET = {"slots": 32, "committees": 64, "k_att": 146, "k_sync": 512,
           "pool_size": 512}


def epoch_signatures(slots, committees, k_att, k_sync) -> int:
    """Signatures an epoch's checks cover (what signatures/s counts)."""
    return slots * (committees * k_att + k_sync + 1)


def epoch_triples(slots, committees, k_att, k_sync, pool_size, pool=None):
    """The epoch's (pubkeys, message, signature) triples in record order."""
    from ..utils.keygen import KeyPool

    pool_size = max(pool_size, k_att, k_sync)
    if pool is None:
        pool = KeyPool(1)  # the switchboard itself, in this process
    privkeys = list(range(1, pool_size + 1))
    pubkeys = pool.sk_to_pk(privkeys)
    shapes = []  # (pubkeys, message, signing key) per check
    for slot in range(slots):
        for c in range(committees):
            start = (slot * committees + c) % (pool_size - k_att + 1)
            msg = (b"att" + slot.to_bytes(8, "little")
                   + c.to_bytes(8, "little") + b"\x00" * 13)
            shapes.append((pubkeys[start:start + k_att], msg,
                           sum(privkeys[start:start + k_att]) % R))
        if k_sync > 0:
            msg = b"sync" + slot.to_bytes(8, "little") + b"\x00" * 20
            shapes.append((pubkeys[:k_sync], msg, sum(privkeys[:k_sync]) % R))
        proposer = slot % pool_size
        msg = b"blk" + slot.to_bytes(8, "little") + b"\x00" * 21
        shapes.append(([pubkeys[proposer]], msg, privkeys[proposer]))
    sigs = pool.sign([(sk, msg) for _, msg, sk in shapes])
    return [(pks, msg, sig) for (pks, msg, _), sig in zip(shapes, sigs)]


def collect(triples) -> SignatureCollector:
    """(pubkeys, message, signature) triples recorded into a port
    SignatureCollector as FastAggregateVerify checks, as if a block replay
    had just been collected."""
    col = SignatureCollector()
    for pks, msg, sig in triples:
        col._fast_aggregate_verify(pks, msg, sig)
    return col


def build_epoch_checks(slots, committees, k_att, k_sync, pool_size,
                       pool=None) -> SignatureCollector:
    """The epoch's checks in a port SignatureCollector."""
    return collect(epoch_triples(slots, committees, k_att, k_sync,
                                 pool_size, pool))
