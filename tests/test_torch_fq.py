"""The port's base-field arithmetic (consensus_specs_tpu_torch/ops/fq.py,
ops/cuda_fq.py) against the JAX package's, limb for limb, on the CPU.

The port's plain Montgomery multiply must equal ``fq.mont_mul_u64`` and the
Pallas kernel (``pallas_fq.mont_mul``, interpret mode) on raw limbs, not
just mod p; the LIN unit must equal ``vm._vm_step_with``'s. Inputs are made
from a seed with numpy/random and handed to both sides.
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import fq as jfq  # noqa: E402
from consensus_specs_tpu.ops import pallas_fq, vm as jvm  # noqa: E402
from consensus_specs_tpu.utils.bls12_381 import P  # noqa: E402
from consensus_specs_tpu_torch.ops import cuda_fq, fq, vm  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()


def _rand_loose(rng, shape, max_bits=401):
    vals = np.zeros(shape + (fq.NUM_LIMBS,), dtype=np.uint64)
    flat = vals.reshape(-1, fq.NUM_LIMBS)
    for i in range(flat.shape[0]):
        flat[i] = fq._int_to_limbs_np(rng.randrange(1 << max_bits))
    return vals


def _t(x):
    return fq.limbs_from_numpy(x, "cpu")


def _edge(value, n=4):
    return np.broadcast_to(value, (n, fq.NUM_LIMBS)).astype(np.uint64)


_ZERO = np.zeros(fq.NUM_LIMBS, dtype=np.uint64)
_PM1 = fq._int_to_limbs_np(P - 1)
_MAXV = np.full(fq.NUM_LIMBS, fq.MASK, dtype=np.uint64)  # 2^420 - 1

# the edge pairs of tests/test_ops_pallas.py::test_pallas_mont_mul_edge_values
EDGE_PAIRS = {
    "zero*one": (_ZERO, fq.ONE_MONT),
    "one*one": (fq.ONE_MONT, fq.ONE_MONT),
    "pm1*pm1": (_PM1, _PM1),
    "max*one": (_MAXV, fq.ONE_MONT),
    "one*max": (fq.ONE_MONT, _MAXV),
    "max*max": (_MAXV, _MAXV),
}


def test_constants_match_reference():
    assert fq.N0 == jfq.N0
    assert fq.MP == jfq.MP
    assert fq.R_MONT == jfq.R_MONT
    for mine, ref in ((fq.P_LIMBS, jfq.P_LIMBS), (fq.ONE_MONT, jfq.ONE_MONT),
                      (fq.MP_LIMBS, jfq.MP_LIMBS)):
        assert np.array_equal(mine, ref)


@pytest.mark.parametrize("n", [4, 300])
@pytest.mark.parametrize("pair", sorted(EDGE_PAIRS))
def test_mont_mul_plain_edge_values(pair, n):
    a, b = (_edge(x, n) for x in EDGE_PAIRS[pair])
    got = fq.mont_mul_plain(_t(a), _t(b)).numpy().astype(np.uint64)
    assert np.array_equal(got, np.asarray(jfq.mont_mul_u64(a, b)))
    assert np.array_equal(got, np.asarray(pallas_fq.mont_mul(a, b)))


@pytest.mark.parametrize("shape", [(1,), (3,), (37,), (5, 3), (300,),
                                   (3, 96)])
def test_mont_mul_plain_random_loose(shape):
    """Random loose values below 2^401, odd batch sizes (the Pallas tile
    is 256 lanes, so all of these pad), up to a few VM rows of 96
    products."""
    rng = random.Random(20261016 + len(shape) * 100 + shape[0])
    a = _rand_loose(rng, shape)
    b = _rand_loose(rng, shape)
    got = fq.mont_mul_plain(_t(a), _t(b)).numpy().astype(np.uint64)
    assert np.array_equal(got, np.asarray(jfq.mont_mul_u64(a, b)))
    assert np.array_equal(got, np.asarray(pallas_fq.mont_mul(a, b)))
    assert got.max() < (1 << fq.LIMB_BITS)
    rinv = pow(fq.R_MONT, -1, P)
    for g, x, y in zip(got.reshape(-1, 15), a.reshape(-1, 15),
                       b.reshape(-1, 15)):
        ix, iy = fq.limbs_to_int(x), fq.limbs_to_int(y)
        assert fq.limbs_to_int(g) % P == ix * iy * rinv % P


def test_mont_mul_broadcasts_batch():
    rng = random.Random(5)
    a = _rand_loose(rng, (4, 3))
    b = _rand_loose(rng, (1, 3))
    got = cuda_fq.mont_mul(_t(a), _t(b)).numpy().astype(np.uint64)
    assert got.shape == (4, 3, fq.NUM_LIMBS)
    assert np.array_equal(got, np.asarray(jfq.mont_mul_u64(a, b)))


def test_cuda_fq_dispatches_cpu_tensors_to_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the launch count only moves on the card."""
    rng = random.Random(9)
    a = _t(_rand_loose(rng, (7,)))
    b = _t(_rand_loose(rng, (7,)))
    before = cuda_fq.LAUNCHES
    assert torch.equal(cuda_fq.mont_mul(a, b), fq.mont_mul_plain(a, b))
    assert cuda_fq.LAUNCHES == before


def test_carry_limbs_matches_reference():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 1 << 40, size=(6, 16), dtype=np.int64)
    for out_limbs in (15, 16):
        got = fq._carry_limbs(torch.from_numpy(t), out_limbs).numpy()
        want = np.asarray(jfq._carry_limbs(jnp.asarray(t.astype(np.uint64)),
                                           out_limbs))
        assert np.array_equal(got.astype(np.uint64), want)


@pytest.mark.parametrize("sub_share", [0.0, 0.5, 1.0])
def test_lin_unit_matches_vm_step_with(sub_share):
    """The LIN unit (add / borrowless subtract) against the reference
    step's: one MUL lane parked on a trash register, 24 LIN lanes."""
    rng = random.Random(int(sub_share * 10) + 11)
    n_regs, w_lin = 64, 24
    regs = _rand_loose(rng, (2, n_regs))
    lsa = np.array([rng.randrange(1, 32) for _ in range(w_lin)], np.int32)
    lsb = np.array([rng.randrange(1, 32) for _ in range(w_lin)], np.int32)
    lsub = np.array([rng.random() < sub_share for _ in range(w_lin)])
    for r in set(lsb[lsub].tolist()):
        regs[:, r] = _rand_loose(rng, (2,), max_bits=381)
    lsd = np.arange(32, 32 + w_lin, dtype=np.int32)
    z = np.zeros(1, np.int32)
    instr = (z, z, np.array([63], np.int32), lsa, lsb, lsub, lsd)

    want, _ = jvm._vm_step_with(
        jfq.mont_mul_u64, jnp.asarray(regs),
        tuple(jnp.asarray(x) for x in instr))
    got = vm._lin_plain(_t(regs)[:, lsa], _t(regs)[:, lsb],
                        torch.from_numpy(lsub))
    assert np.array_equal(got.numpy().astype(np.uint64),
                          np.asarray(want)[:, lsd])


@pytest.mark.parametrize("x", [0, 1, 2, P - 1, P // 3, 2**380 + 12345])
def test_mont_roundtrip_and_reference_encoding(x):
    limbs = fq.to_mont_int(x)
    assert np.array_equal(limbs, jfq.to_mont_int(x))
    assert fq.from_mont_limbs(limbs) == x
    loose = fq._int_to_limbs_np(fq.limbs_to_int(limbs) + 3 * P)  # loose rep
    assert fq.from_mont_limbs(loose) == x


def test_limbs_from_numpy_rejects_wide_limbs():
    ok = fq.limbs_from_numpy(np.full((2, 15), fq.MASK, np.uint64), "cpu")
    assert ok.dtype == torch.int64 and int(ok.max()) == fq.MASK
    with pytest.raises(ValueError):
        fq.limbs_from_numpy(np.full((2, 15), 1 << 28, np.uint64), "cpu")
