"""Prep-only microbenchmark of the port: batched input codec vs per-item
host prep (the counterpart of consensus_specs_tpu/bench/codec_prep.py),
``run_codec_bench(device=None)``.

Measures the front-door cost the codec plane (ops/codec.py) was built to
kill: decode+KeyValidate of N pubkeys, decode+subgroup-check of N
signatures, and hash-to-G2 of N messages, once through the per-item
exact-int compute functions (``ops/bls_backend._*_limbs_compute``, the
cache-miss path) and once through the batched codec entry points
(``codec.pubkey_limbs_batch`` / ``signature_limbs_batch`` /
``message_limbs_batch``) on ``device``: on the card the codec's tensor
path, whose chains and subgroup programs run on kernels 2 and 1; on the
CPU the raw-int host path. No pairing work on either side.

Setup (constructing N valid points via oracle scalar multiplies) is
excluded from the timed regions, and so is one untimed batched pass over
a second input set of the same size, which assembles the codec's
programs and captures its chains. ``outputs_match`` holds every batched
output equal to the per-item one, limb for limb. Knobs: CODEC_ITEMS
(default 64), CODEC_SEED.
"""
import os
import time
from typing import Dict, List


def _build_inputs(n: int, seed: int):
    """N distinct pubkeys / signatures / messages (one scalar multiply
    each: setup stays linear and outside the timed window)."""
    import hashlib

    from ..utils import bls12_381 as O

    pks: List[bytes] = []
    sigs: List[bytes] = []
    msgs: List[bytes] = []
    for i in range(n):
        k = (
            int.from_bytes(
                hashlib.sha256(b"codec-bench%d:%d" % (seed, i)).digest(),
                "big",
            )
            % O.R
        ) or 1
        pks.append(O.g1_to_bytes(O.ec_mul(O.G1_GEN, k)))
        sigs.append(O.g2_to_bytes(O.ec_mul(O.G2_GEN, k)))
        msgs.append(hashlib.sha256(b"codec-msg%d:%d" % (seed, i)).digest())
    return pks, sigs, msgs


def _same(a, b) -> bool:
    """One batched output against the per-item one: equal limbs, or the
    same error message."""
    import numpy as np

    if isinstance(a, Exception) or isinstance(b, Exception):
        return type(a) is type(b) and str(a) == str(b)
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(np.array_equal(x, y) for x, y in zip(a, b)))
    return np.array_equal(np.asarray(a), np.asarray(b))


def run_codec_bench(device=None) -> dict:
    """Returns the JAX bench's result dict; value is batched-codec
    items/sec over all three kinds, vs_baseline is the speedup over the
    per-item path (>1 means the codec wins)."""
    from ..device import resolve_device
    from ..ops import bls_backend, codec

    dev = resolve_device(device)
    n = int(os.environ.get("CODEC_ITEMS", "64"))
    seed = int(os.environ.get("CODEC_SEED", "7"))
    pks, sigs, msgs = _build_inputs(n, seed)

    def batched_pass(pk_in, sig_in, msg_in, times):
        outs = {}
        for kind, fn, args in (
            ("pk", codec.pubkey_limbs_batch, (pk_in,)),
            ("sig", codec.signature_limbs_batch, (sig_in,)),
            ("msg", codec.message_limbs_batch, (msg_in, bls_backend.DST)),
        ):
            t0 = time.perf_counter()
            outs[kind] = fn(*args, device=dev)
            times[kind] = time.perf_counter() - t0
        return outs

    # untimed: program assembly and chain capture on a second input set
    batched_pass(*_build_inputs(n, seed + 1), {})

    # per-item path (the cache-miss path the codec replaces)
    per_item: Dict[str, float] = {}
    expect = {}
    for kind, fn, items in (
        ("pk", bls_backend._pubkey_limbs_compute, pks),
        ("sig", bls_backend._signature_limbs_compute, sigs),
        ("msg", bls_backend._message_limbs_compute, msgs),
    ):
        t0 = time.perf_counter()
        expect[kind] = [fn(x) for x in items]
        per_item[kind] = time.perf_counter() - t0

    batched: Dict[str, float] = {}
    got = batched_pass(pks, sigs, msgs, batched)
    outputs_match = all(
        len(got[k]) == len(expect[k])
        and all(_same(a, b) for a, b in zip(got[k], expect[k]))
        for k in expect)

    total_items = 3 * n
    per_item_s = sum(per_item.values())
    batched_s = sum(batched.values())
    speedup = per_item_s / batched_s if batched_s else 0.0
    return dict(
        metric="codec prep items/sec (batched input codec, all kinds)",
        value=total_items / batched_s if batched_s else 0.0,
        vs_baseline=round(speedup, 4),  # here: speedup over per-item prep
        mode="codec",
        platform=dev.type,
        items_per_kind=n,
        device_path=codec._use_device(dev),
        outputs_match=bool(outputs_match),
        per_item_items_per_sec=round(
            total_items / per_item_s if per_item_s else 0.0, 2
        ),
        speedup=round(speedup, 4),
        per_kind_speedup={
            k: round(per_item[k] / batched[k], 4) if batched[k] else 0.0
            for k in per_item
        },
        per_item_ms={k: round(1e3 * v, 2) for k, v in per_item.items()},
        batched_ms={k: round(1e3 * v, 2) for k, v in batched.items()},
    )
