"""The port's verify path (consensus_specs_tpu_torch/ops/bls_backend.py)
against the JAX package's, as a whole, on the CPU.

Both backends get the same batches and must return the same verdict
vectors (and the planted ones): valid items, a wrong message, a corrupted
signature, malformed bytes, an infinity pubkey, an empty pubkey set and
points on the curve outside the prime-order subgroup. PROG A's outputs
(``f.*``, ``aggz``) must match limb for limb. Shapes stay in the k=2/4
buckets, N <= 4, as tests/test_bls_backend_fast.py runs them.
"""
import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import pytest  # noqa: E402

from consensus_specs_tpu.ops import bls_backend as jbls  # noqa: E402
from consensus_specs_tpu.utils import bls  # noqa: E402
from consensus_specs_tpu.utils import bls12_381 as O  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend as tbls  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

SKS = [41, 42, 43, 44]
PKS = [bls.SkToPk(sk) for sk in SKS]
MSG = b"\x05" * 32
OTHER = b"\x06" * 32


def _agg_sig(sks, msg):
    return bls.Sign(sum(sks) % O.R, msg)


def _off_subgroup_g1() -> bytes:
    """A G1 point on y^2 = x^3 + 4 outside the order-r subgroup."""
    x = 5
    while True:
        y = O.fq_sqrt((x ** 3 + 4) % O.P)
        if y is not None:
            pt = O.ec_from_affine((O.Fq(x), O.Fq(y)))
            if not O.is_in_g1_subgroup(pt):
                return O.g1_to_bytes(pt)
        x += 1


def _off_subgroup_g2() -> bytes:
    """A G2 point on the twist outside the order-r subgroup."""
    x0 = 3
    while True:
        x = O.Fq2(x0, 1)
        y = (x * x * x + O.B_G2).sqrt()
        if y is not None:
            pt = O.ec_from_affine((x, y))
            if not O.is_in_g2_subgroup(pt):
                return O.g2_to_bytes(pt)
        x0 += 1


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side as its own tests run it: interpreter, mode '0', the
    hard-part variant routed by batch size."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.delenv("CONSENSUS_SPECS_TPU_HARD_PART", raising=False)


def _fast_batch_a():
    """k=4 bucket: valid, wrong message, corrupted signature, infinity
    pubkey."""
    sig3 = _agg_sig(SKS[:3], MSG)
    corrupted = sig3[:-1] + bytes([sig3[-1] ^ 0x01])
    inf_pk = bytes([0xC0]) + b"\x00" * 47
    return (
        [PKS[:3], PKS[:3], PKS[:3], [PKS[0], inf_pk]],
        [MSG, OTHER, MSG, MSG],
        [sig3, sig3, corrupted, _agg_sig(SKS[:1], MSG)],
        [True, False, False, False],
    )


def _fast_batch_b():
    """k=2 bucket: valid, malformed bytes, empty set, off-subgroup
    pubkey."""
    sig2 = _agg_sig(SKS[:2], OTHER)
    return (
        [PKS[:2], [PKS[0][:47]], [], [PKS[0], _off_subgroup_g1()]],
        [OTHER, OTHER, OTHER, OTHER],
        [sig2, sig2[:95], sig2, sig2],
        [True, False, False, False],
    )


@pytest.mark.parametrize("batch", [_fast_batch_a, _fast_batch_b],
                         ids=["k4", "k2"])
def test_batch_fast_aggregate_verify_matches_reference(batch):
    pks, msgs, sigs, expected = batch()
    want = jbls.batch_fast_aggregate_verify(pks, msgs, sigs)
    got = tbls.batch_fast_aggregate_verify(pks, msgs, sigs, device="cpu")
    assert got.dtype == bool
    assert list(got) == list(want) == expected


def test_batch_aggregate_verify_matches_reference():
    """Distinct messages per pubkey: valid, one message swapped, an
    off-subgroup signature."""
    m0, m1 = b"\x11" * 32, b"\x22" * 32
    sig = bls.Aggregate([bls.Sign(SKS[0], m0), bls.Sign(SKS[1], m1)])
    pks = [PKS[:2], PKS[:2], PKS[:2]]
    msgs = [[m0, m1], [m0, m0], [m0, m1]]
    sigs = [sig, sig, _off_subgroup_g2()]
    want = jbls.batch_aggregate_verify(pks, msgs, sigs)
    got = tbls.batch_aggregate_verify(pks, msgs, sigs, device="cpu")
    assert list(got) == list(want) == [True, False, False]


def test_miller_stage_outputs_match_reference_limbs():
    """PROG A (aggregate + both Miller loops): every f.* and aggz output of
    the port equals the JAX package's, limb for limb."""
    pks, msgs, sigs, _ = _fast_batch_a()
    want, wlay, wpre = jbls._miller_fast_aggregate(pks, msgs, sigs)
    got, lay, pre = tbls._miller_fast_aggregate(pks, msgs, sigs, "cpu")
    assert np.array_equal(pre, wpre)
    assert (lay.rows, lay.fold) == (wlay.rows, wlay.fold)
    assert sorted(got) == sorted(want)
    # names are "i{t}.f.{j}" / "i{t}.aggz" for fold > 1
    base = [n.split(".", 1)[1] if lay.fold > 1 else n for n in got]
    assert sum(b.startswith("f.") or b == "aggz" for b in base) == 13 * lay.fold
    for name in got:
        assert np.array_equal(got[name], np.asarray(want[name])), name


def test_host_prep_failures_skip_the_device():
    """A batch in which no item survives host prep is all False on both
    sides, without a device stage."""
    bad = [[PKS[0][:10]], []]
    sigs = [b"\x00" * 96, _agg_sig(SKS[:1], MSG)]
    want = jbls.batch_fast_aggregate_verify(bad, [MSG, MSG], sigs)
    got = tbls.batch_fast_aggregate_verify(bad, [MSG, MSG], sigs,
                                           device="cpu")
    assert list(got) == list(want) == [False, False]
    assert tbls.batch_fast_aggregate_verify([], [], [], device="cpu").size == 0


def test_routing_tables_match_reference():
    for k in (1, 2, 3, 4, 100, 146, 160, 161, 2048):
        assert tbls._k_bucket(k) == jbls._k_bucket(k)
    for kind in ("miller_product", "aggregate_verify", "hard_part",
                 "hard_part_frobenius", "hard_part_windowed"):
        for k in (0, 2, 160, 256, 512, 1024):
            for n in (1, 3, 64, 1 << 30):
                assert tbls._fold_for(kind, k, n) == jbls._fold_for(kind, k, n)
    for n in (1, 16, 17, 64):
        assert tbls._hard_part_kind(n) == jbls._hard_part_kind(n)
    with pytest.raises(ValueError):
        tbls._k_bucket(2049)
