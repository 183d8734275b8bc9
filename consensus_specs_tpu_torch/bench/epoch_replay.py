"""The epoch of signature checks (BASELINE config 4), built for the port's
``SignatureCollector`` and replayed: the counterpart of
consensus_specs_tpu/bench/epoch_replay.py, with ``build_epoch_checks`` (the
same triples for the same shape) and ``run_epoch_replay(device=None)``.

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
spawned processes. Nothing is cached on disk: each run builds its checks
anew and seeds the backend's host caches through ``prewarm_host_caches``
(the batched codec) before the timed flushes.

Env: BENCH_EPOCH_SLOTS, BENCH_EPOCH_COMMITTEES, BENCH_EPOCH_K,
BENCH_EPOCH_K_SYNC, BENCH_EPOCH_POOL (pubkey pool size), BENCH_REPS; with
CONSENSUS_SPECS_TPU_RLC=0 the flushes run per item.
"""
import os
import time

from ..batch_verify import SignatureCollector
from ..utils.bls12_381 import R

TARGET_PER_CHIP = 150_000 / 8

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


def _env_int(name, default):
    return int(os.environ.get(name, str(default)))


def _seed_host_caches(col, device) -> None:
    """Decode, subgroup-check and hash every distinct input of the checks
    into the backend's host caches (the batched codec on ``device``), so
    the timed flushes measure verification, not input prep."""
    from ..ops import bls_backend

    msgs, sigs, pks = set(), set(), set()
    for c in col.checks:
        if isinstance(c.messages, (bytes, bytearray)):
            msgs.add(bytes(c.messages))
        else:  # aggregate kind: a message a key
            msgs.update(bytes(m) for m in c.messages)
        sigs.add(bytes(c.signature))
        pks.update(bytes(p) for p in c.pubkeys)
    bls_backend.prewarm_host_caches(sorted(msgs), sorted(sigs), sorted(pks),
                                    device)


def run_epoch_replay(device=None) -> dict:
    """Run the epoch workload on ``device`` (None: the CUDA card); returns
    the JAX bench's result dict. The card runs the mainnet shape, the CPU
    the JAX bench's CPU shape (2 x 2 x 8, sync 16); env knobs win."""
    from ..device import resolve_device
    from ..ops.bls_backend import rlc_enabled
    from ..utils.keygen import KeyPool

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    slots = _env_int("BENCH_EPOCH_SLOTS", 2 if on_cpu else 32)
    committees = _env_int("BENCH_EPOCH_COMMITTEES", 2 if on_cpu else 64)
    k_att = _env_int("BENCH_EPOCH_K", 8 if on_cpu else 146)
    k_sync = _env_int("BENCH_EPOCH_K_SYNC", 16 if on_cpu else 512)
    pool_size = _env_int("BENCH_EPOCH_POOL", max(k_att, k_sync))
    reps = _env_int("BENCH_REPS", 2 if on_cpu else 1)

    n_sigs = epoch_signatures(slots, committees, k_att, k_sync)
    # one final exponentiation for the whole epoch unless
    # CONSENSUS_SPECS_TPU_RLC=0 asks for per-item finalization
    rlc = rlc_enabled()

    t0 = time.perf_counter()
    n_checks = slots * (committees + (1 if k_sync > 0 else 0) + 1)
    # the key pool's spawned processes pay off past a few dozen signatures
    with KeyPool(None if n_checks > 64 else 1) as pool:
        col = build_epoch_checks(slots, committees, k_att, k_sync,
                                 pool_size, pool=pool)
    _seed_host_caches(col, dev)
    setup_s = time.perf_counter() - t0

    # the warm-up flush assembles each bucket's programs; its timing is
    # reported beside the reps
    t0 = time.perf_counter()
    ok = col.flush(device=dev, rlc=rlc)
    warm_s = time.perf_counter() - t0
    assert ok.all(), "epoch warmup verification failed"

    rep_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ok = col.flush(device=dev, rlc=rlc)
        dt = time.perf_counter() - t0
        assert ok.all(), "epoch verification failed"
        rep_times.append(dt)
    rep_times.sort()
    # the median of the reps, as committee mode
    best = rep_times[len(rep_times) // 2] if rep_times else warm_s
    return dict(
        value=n_sigs / best,
        vs_baseline=n_sigs / best / TARGET_PER_CHIP,
        platform=dev.type,
        mode="epoch",
        slots=slots,
        committees=committees,
        k=k_att,
        signatures=n_sigs,
        rlc=rlc,
        epoch_seconds=round(best, 3),
        warmup_seconds=round(warm_s, 3),
        setup_seconds=round(setup_s, 1),
        checks=len(col.checks),
    )
