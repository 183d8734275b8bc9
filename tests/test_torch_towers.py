"""The port's loose-limb API (consensus_specs_tpu_torch/ops/fq.py), Fq12
tower arithmetic (ops/towers.py) and tower combine (ops/pairing.py)
against the JAX package's, raw limbs equal, on the CPU.

Inputs are seeded random loose limbs: Fq values below 2^401 (the JAX
package's loose bound) and Fq12 coefficients below 2^382 (PROG A's
compressed outputs, what the combine is fed).
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import bls_backend as jbls  # noqa: E402
from consensus_specs_tpu.ops import fq as jfq  # noqa: E402
from consensus_specs_tpu.ops import pairing as jpairing  # noqa: E402
from consensus_specs_tpu.ops import towers as jtowers  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend as tbls  # noqa: E402
from consensus_specs_tpu_torch.ops import cuda_fq, fq, pairing, towers  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side's Montgomery product on its jnp uint64 lowering."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")


def _rand_loose(rng, shape, max_bits=401):
    vals = np.zeros(shape + (fq.NUM_LIMBS,), dtype=np.uint64)
    flat = vals.reshape(-1, fq.NUM_LIMBS)
    for i in range(flat.shape[0]):
        flat[i] = fq._int_to_limbs_np(rng.randrange(1 << max_bits))
    return vals


def _t(x):
    return fq.limbs_from_numpy(x, "cpu")


def _np(x):
    return x.numpy().astype(np.uint64)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_binary_limb_ops_match_reference(op):
    rng = random.Random(101 + len(op))
    a = _rand_loose(rng, (5, 3))
    b = _rand_loose(rng, (5, 3))
    got = _np(getattr(fq, op)(_t(a), _t(b)))
    want = np.asarray(getattr(jfq, op)(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)


def test_compress_matches_reference():
    rng = random.Random(210)
    a = _rand_loose(rng, (7,))
    a[0] = 0
    a[1] = fq.P_LIMBS
    got = _np(fq.compress(_t(a)))
    assert np.array_equal(got, np.asarray(jfq.compress(jnp.asarray(a))))


def test_mont_mul_runs_plain_version_on_cpu_tensors(monkeypatch):
    """fq.mont_mul on a CPU tensor is fq.mont_mul_plain: no kernel launch."""
    rng = random.Random(404)
    a, b = _t(_rand_loose(rng, (6,))), _t(_rand_loose(rng, (6,)))
    calls = []
    plain = fq.mont_mul_plain

    def counted(x, y):
        calls.append(x.shape)
        return plain(x, y)

    monkeypatch.setattr(fq, "mont_mul_plain", counted)
    launches = cuda_fq.LAUNCHES
    got = fq.mont_mul(a, b)
    assert calls == [a.shape]
    assert cuda_fq.LAUNCHES == launches
    assert torch.equal(got, plain(a, b))


@pytest.mark.parametrize("fn", ["fq12_mul", "fq12_square"])
def test_fq12_ops_match_reference(fn):
    rng = random.Random(505 + len(fn))
    a = _rand_loose(rng, (3, 12), 382)
    b = _rand_loose(rng, (3, 12), 382)
    args = (a, b) if fn == "fq12_mul" else (a,)
    got = _np(getattr(towers, fn)(*(_t(x) for x in args)))
    want = np.asarray(getattr(jtowers, fn)(*(jnp.asarray(x) for x in args)))
    assert got.shape == (3, 12, fq.NUM_LIMBS)
    assert np.array_equal(got, want)


def test_fq12_one_select():
    rng = random.Random(606)
    a = _rand_loose(rng, (2, 12), 382)
    b = _rand_loose(rng, (2, 12), 382)
    assert np.array_equal(_np(towers.fq12_one((2,), "cpu")),
                          np.asarray(jtowers.fq12_one((2,))))
    cond = np.array([True, False])
    assert np.array_equal(
        _np(towers.fq12_select(torch.from_numpy(cond), _t(a), _t(b))),
        np.asarray(jtowers.fq12_select(jnp.asarray(cond), jnp.asarray(a),
                                       jnp.asarray(b))))


@pytest.mark.parametrize("n", [2, 3])
def test_rlc_combine_matches_reference(n):
    """prod f_i^{r_i} over 128 runtime bits, then the pairwise tree (n = 3
    carries a leftover): raw limbs equal to the JAX package's; the port's
    tower backend decodes to the same flat coefficients."""
    rng = random.Random(707 + n)
    fs = _rand_loose(rng, (n, 12), 382)
    bits = tbls._rlc_scalars(n, rng)
    got = _np(pairing.rlc_combine(_t(fs), torch.from_numpy(bits)))
    want = np.asarray(jpairing.rlc_combine(fs, bits.astype(bool)))
    assert got.shape == (12, fq.NUM_LIMBS)
    assert np.array_equal(got, want)
    flat = tbls._rlc_combine_tower(fs, bits, torch.device("cpu"))
    assert flat == [jfq.from_mont_limbs(want[j]) for j in range(12)]
    # and the tower value is the oracle's prod f_i^{r_i}
    total = None
    for f, row in zip(fs, bits):
        x = jbls._flat_ints_to_oracle([fq.from_mont_limbs(c) for c in f])
        x = x.pow(int("".join(str(int(b)) for b in row), 2))
        total = x if total is None else total * x
    assert flat == jbls._oracle_to_flat_ints(total)
