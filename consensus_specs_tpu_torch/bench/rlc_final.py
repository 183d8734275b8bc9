"""RLC microbenchmark of the port (the counterpart of
consensus_specs_tpu/bench/rlc_final.py), ``run_rlc_bench(device=None)``:
per-item final exponentiation vs the random-linear-combination combine,
items/sec across batch sizes.

Both contenders get the SAME (N, 12, L) Miller-output rows: PROG A runs
once on a couple of real committees and its f rows are tiled to N (the
finalization cost is data-independent; the RLC scalars stay fresh per
item), so the race isolates exactly what batch_verify_rlc changes:

  per-item: N serial host easy parts + N hard-part rows on ``device``
            (ops/bls_backend._finalize_per_item, the pre-RLC pipeline);
  RLC:      ONE rlc_combine program over the N rows (chunked) + ONE easy
            part + ONE hard part (a device row on the card, the exact-int
            oracle on the CPU: ``_rlc_final_mode``).

The per-item hard part amortizes through lane folding, so the combine must
beat a fold-32 hard-part program, not a one-row-per-item loop. The
result's ``rlc_stats`` (``bls_backend.RLC_STATS`` over the run) shows the
combines and final exponentiations paid, and 0 bisections: every row is
valid.

Env: RLC_BENCH_NS (default "4,16,64,256"), RLC_BENCH_REPS (default 1,
best-of over reps after a warmup), RLC_BENCH_SEED.
"""
import os
import random
import time

import numpy as np


def _build_f_rows(seed: int, device) -> np.ndarray:
    """(2, 12, L) Miller-output rows from two real K=2 committee checks
    (both valid), through the shared PROG A stage on ``device``."""
    from ..ops import bls_backend as bb
    from ..utils import bls
    from ..utils.bls12_381 import R

    sks = [seed * 100 + 1, seed * 100 + 2]
    pks = [bls.SkToPk(sk) for sk in sks]
    msgs = [b"rlc-bench-%d" % i + b"\x00" * 20 for i in range(2)]
    sigs = [bls.Sign(sum(sks) % R, m) for m in msgs]
    out, lay, precheck = bb._miller_fast_aggregate(
        [pks, pks], msgs, sigs, device
    )
    assert out is not None and precheck[:2].all()
    rows = []
    for i in range(2):
        r, ns = lay.split(i)
        rows.append(np.stack([out[f"{ns}f.{j}"][r] for j in range(12)]))
    return np.stack(rows)


def run_rlc_bench(device=None) -> dict:
    """Returns the JAX bench's result dict. ``value`` is RLC items/sec at
    the largest N; ``vs_baseline`` is the RLC-over-per-item speedup at
    N=16 (> 1 means the combine wins where the acceptance bar sits); the
    ``sizes`` table carries every N."""
    from ..device import resolve_device
    from ..ops import bls_backend as bb

    dev = resolve_device(device)
    ns = [
        int(x)
        for x in os.environ.get("RLC_BENCH_NS", "4,16,64,256").split(",")
    ]
    reps = max(1, int(os.environ.get("RLC_BENCH_REPS", "1")))
    seed = int(os.environ.get("RLC_BENCH_SEED", "7"))
    rng = random.Random(seed)

    base = _build_f_rows(seed, dev)
    bb.reset_rlc_stats()

    def rlc_once(fs):
        bits = bb._rlc_scalars(fs.shape[0], rng)
        coeffs = bb._rlc_combine_vm(fs, bits, dev)
        ok = bb._final_exp_is_one(coeffs, dev)
        assert ok, "rlc combined check failed on valid items"

    sizes = {}
    for n in ns:
        fs = base[np.arange(n) % base.shape[0]]
        # the warmup pays program assembly for both contenders' shapes
        got = bb._finalize_per_item(fs, dev)
        assert got.all(), "per-item finalization failed on valid items"
        rlc_once(fs)

        per_item_s = min(
            _timed(lambda: bb._finalize_per_item(fs, dev)) for _ in range(reps)
        )
        rlc_s = min(_timed(lambda: rlc_once(fs)) for _ in range(reps))
        sizes[n] = {
            "per_item_items_per_s": round(n / per_item_s, 2),
            "rlc_items_per_s": round(n / rlc_s, 2),
            "rlc_speedup": round(per_item_s / rlc_s, 3),
        }

    n_gate = 16 if 16 in sizes else max(sizes)
    n_top = max(sizes)
    return dict(
        metric="RLC vs per-item final exponentiation (items/sec)",
        value=sizes[n_top]["rlc_items_per_s"],
        vs_baseline=sizes[n_gate]["rlc_speedup"],
        mode="rlc",
        platform=dev.type,
        n=n_top,
        gate_n=n_gate,
        chunk=bb._rlc_chunk_max(),
        final=bb._rlc_final_mode(dev),
        reps=reps,
        sizes={str(k): v for k, v in sorted(sizes.items())},
        rlc_stats=dict(bb.RLC_STATS),
    )


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
