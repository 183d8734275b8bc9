"""The codec prewarm on the port's verify path (consensus_specs_tpu_torch/
ops/bls_backend.py: prewarm_host_caches, PREP_STATS, and the prewarm at
the top of _miller_fast_aggregate / _miller_aggregate) against the JAX
package's, on the CPU.

A small slot with invalid items (a wrong message, a corrupted signature,
an infinity pubkey, a signature outside G2) goes through
batch_fast_aggregate_verify and batch_verify_rlc on both sides from cold
caches: the verdicts and the PREP_STATS the prewarm leaves must be the
JAX package's, with the codec (on its CPU placement, the raw-int path;
tests/test_torch_codec_batch.py holds the tensor path to it) and with
CONSENSUS_SPECS_TPU_BATCH_CODEC=0. The JAX side runs its VM in the
interpreter with the jnp Montgomery product and prepares serially
(CONSENSUS_SPECS_TPU_HASH_PROCS=1: the port has no process pool).
"""
import contextlib
import functools
import os
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import pytest  # noqa: E402

from consensus_specs_tpu.ops import bls_backend as jbls  # noqa: E402
from consensus_specs_tpu.utils import bls  # noqa: E402
from consensus_specs_tpu.utils import bls12_381 as JO  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend as tbls  # noqa: E402
from consensus_specs_tpu_torch.ops import codec  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

SKS = [71, 72, 73, 74]
PKS = [bls.SkToPk(sk) for sk in SKS]
M0, M1, M2 = b"\x31" * 32, b"\x32" * 32, b"\x33" * 32


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_HASH_PROCS", "1")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_CHUNK", "2")
    for var in ("CONSENSUS_SPECS_TPU_BATCH_CODEC",
                "CONSENSUS_SPECS_TPU_CODEC_DEVICE",
                "CONSENSUS_SPECS_TPU_HARD_PART", "CONSENSUS_SPECS_TPU_RLC_FINAL",
                "CONSENSUS_SPECS_TPU_RLC_BACKEND"):
        monkeypatch.delenv(var, raising=False)


def _cold():
    """Both packages' limb caches empty and their prep counters at 0."""
    for mod in (jbls, tbls):
        for cache in (mod._MSG_CACHE, mod._SIG_CACHE, mod._PK_CACHE):
            cache.clear()
        mod.reset_prep_state()


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _off_subgroup_g2() -> bytes:
    x0 = 3
    while True:
        x = JO.Fq2(x0, 1)
        y = (x * x * x + JO.B_G2).sqrt()
        if y is not None:
            pt = JO.ec_from_affine((x, y))
            if not JO.is_in_g2_subgroup(pt):
                return JO.g2_to_bytes(pt)
        x0 += 1


def _agg_sig(sks, msg):
    return bls.Sign(sum(sks) % JO.R, msg)


def _slot():
    """k=2 bucket, 6 items: valid, valid (one key shared with the first),
    a wrong message, a corrupted signature, an infinity pubkey, a
    signature outside G2."""
    sig01 = _agg_sig(SKS[:2], M0)
    sig12 = _agg_sig(SKS[1:3], M1)
    corrupted = sig12[:-1] + bytes([sig12[-1] ^ 0x01])
    inf_pk = bytes([0xC0]) + b"\x00" * 47
    return (
        [PKS[:2], PKS[1:3], PKS[:2], PKS[1:3], [PKS[3], inf_pk], PKS[2:4]],
        [M0, M1, M2, M1, M2, M2],
        [sig01, sig12, sig01, corrupted, _agg_sig(SKS[3:], M2),
         _off_subgroup_g2()],
        [True, True, False, False, False, False],
    )


def _compute(fn, blob):
    """A per-item compute function's result, its raised ValueError as a
    value."""
    try:
        return fn(blob)
    except ValueError as e:
        return e


def _jax_stats():
    return {k: jbls.PREP_STATS[k] for k in tbls.PREP_STATS}


@functools.lru_cache(maxsize=None)
def _jax_slot_run(codec_on: bool):
    """The JAX package on the slot from cold caches: (verdicts,
    PREP_STATS)."""
    pks, msgs, sigs, _ = _slot()
    _cold()
    with _env(CONSENSUS_SPECS_TPU_BATCH_CODEC="1" if codec_on else "0"):
        got = jbls.batch_fast_aggregate_verify(pks, msgs, sigs)
    return list(got), _jax_stats()


# distinct messages, signatures and pubkeys of the slot, and the failures
# among them (never cached, so prepared again on every call): the
# corrupted and the off-subgroup signature, the infinity pubkey
N_MISSES = 3 + 5 + 5
N_FAILURES = 3


@pytest.mark.parametrize("mode", ["codec", "per_item"])
def test_fast_aggregate_verdicts_and_prep_stats(mode, monkeypatch):
    codec_on = mode == "codec"
    want, want_stats = _jax_slot_run(codec_on)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_BATCH_CODEC",
                       "1" if codec_on else "0")
    pks, msgs, sigs, expected = _slot()
    _cold()
    got = tbls.batch_fast_aggregate_verify(pks, msgs, sigs, device="cpu")
    assert list(got) == want == expected
    assert tbls.PREP_STATS == want_stats
    if codec_on:
        assert tbls.PREP_STATS == {"codec_batches": 1, "codec_items": N_MISSES,
                                   "serial_fallback_items": 0}
        # the failures were not cached, the successes were
        assert sigs[5] not in tbls._SIG_CACHE and sigs[0] in tbls._SIG_CACHE
    else:
        assert tbls.PREP_STATS == {"codec_batches": 0, "codec_items": 0,
                                   "serial_fallback_items": N_MISSES}
    if codec_on:
        # warm: only the failures are prepared again
        got = tbls.batch_fast_aggregate_verify(pks, msgs, sigs, device="cpu")
        assert list(got) == expected
        assert tbls.PREP_STATS == {
            "codec_batches": 2, "codec_items": N_MISSES + N_FAILURES,
            "serial_fallback_items": 0}


def test_batch_verify_rlc_verdicts_and_prep_stats(monkeypatch):
    """fast_aggregate and aggregate items through one RLC call: both
    _miller_fast_aggregate and _miller_aggregate prewarm (two codec
    passes). The items that fail prep never reach the combine, so one
    combine of the two valid items decides the call. Per-item prep
    (CONSENSUS_SPECS_TPU_BATCH_CODEC=0) gives the same verdicts."""
    pks, msgs, sigs, _ = _slot()
    items = [("fast_aggregate", pks[i], msgs[i], sigs[i]) for i in (0, 3, 4, 5)]
    agg_sig = bls.Aggregate([bls.Sign(SKS[0], M1), bls.Sign(SKS[1], M2)])
    items.append(("aggregate", PKS[:2], [M1, M2], agg_sig))
    expected = [True, False, False, False, True]
    _cold()
    want = jbls.batch_verify_rlc(items, rng=random.Random(7))
    got = tbls.batch_verify_rlc(items, device="cpu", rng=random.Random(7))
    assert list(got) == list(want) == expected
    assert tbls.PREP_STATS == _jax_stats()
    assert tbls.PREP_STATS["codec_batches"] == 2
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_BATCH_CODEC", "0")
    _cold()
    got = tbls.batch_verify_rlc(items, device="cpu", rng=random.Random(7))
    assert list(got) == expected
    assert tbls.PREP_STATS["codec_batches"] == 0
    assert tbls.PREP_STATS["serial_fallback_items"] > 0


def test_prewarm_fills_the_caches_like_the_per_item_path():
    pks, msgs, sigs, _ = _slot()
    flat_pks = [pk for s in pks for pk in s] + [PKS[0][:47]]
    _cold()
    tbls.prewarm_host_caches(msgs, sigs, flat_pks, device="cpu")
    for m in set(msgs):
        assert np.array_equal(tbls._MSG_CACHE[m],
                              tbls._message_limbs_compute(m))
    for s in set(sigs):
        want = _compute(tbls._signature_limbs_compute, s)
        if isinstance(want, ValueError):
            assert s not in tbls._SIG_CACHE
        else:
            assert np.array_equal(tbls._SIG_CACHE[s], want)
    for p in set(flat_pks):
        want = _compute(tbls._pubkey_limbs_compute, p)
        if isinstance(want, ValueError):
            assert p not in tbls._PK_CACHE
            with pytest.raises(ValueError, match=str(want)):
                tbls._pubkey_limbs(p)
        else:
            assert all(np.array_equal(a, b)
                       for a, b in zip(tbls._PK_CACHE[p], want))
    before = dict(tbls.PREP_STATS)
    tbls.prewarm_host_caches(msgs, sigs[:3], [PKS[0]], device="cpu")
    assert tbls.PREP_STATS == before  # all cached: nothing to prepare


def test_codec_failure_raises_and_does_not_fall_back(monkeypatch):
    """A codec error reaches the caller; the per-item path is not tried."""
    def boom(*args, **kwargs):
        raise RuntimeError("codec failed")

    def per_item(*args, **kwargs):
        raise AssertionError("fell back to per-item prep")

    monkeypatch.setattr(codec, "signature_limbs_batch", boom)
    monkeypatch.setattr(tbls, "_signature_limbs_compute", per_item)
    pks, msgs, sigs, _ = _slot()
    _cold()
    with pytest.raises(RuntimeError, match="codec failed"):
        tbls.batch_fast_aggregate_verify(pks, msgs, sigs, device="cpu")
    assert tbls.PREP_STATS["codec_batches"] == 0
