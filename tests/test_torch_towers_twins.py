"""The rest of the port's tower arithmetic (consensus_specs_tpu_torch/
ops/towers.py: the Fq2 helpers, the Fq12 component views, Frobenius,
the tower inversion and the oracle converters) against the JAX
package's ops/towers.py on the CPU, raw limbs equal (tolerance 0).

Inputs are seeded batches of 3: Fq values below 2^401 (the JAX package's
loose bound), Fq12 coefficients below 2^382 (compressed values, what the
Miller loop and the final exponentiation carry). The JAX functions run
eagerly: jitted whole, the inversion alone spends minutes in XLA's CPU
compiler, while eager dispatch takes seconds; both run the same integer
operations.
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from consensus_specs_tpu.ops import towers as jtowers  # noqa: E402
from consensus_specs_tpu.utils import bls12_381 as JO  # noqa: E402
from consensus_specs_tpu_torch.ops import fq, towers  # noqa: E402
from consensus_specs_tpu_torch.utils import bls12_381 as TO  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

BATCH = 3


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side's Montgomery product on its jnp uint64 lowering."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")


def _rand(rng, shape, max_bits):
    vals = np.zeros(shape + (fq.NUM_LIMBS,), dtype=np.uint64)
    flat = vals.reshape(-1, fq.NUM_LIMBS)
    for i in range(flat.shape[0]):
        flat[i] = fq._int_to_limbs_np(rng.randrange(1 << max_bits))
    return vals


def _t(x):
    return fq.limbs_from_numpy(x, "cpu")


def _np(x):
    return x.numpy().astype(np.uint64)


def _same(got, want):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


FQ2_UNARY = ["fq2_double", "fq2_conjugate", "_fq2_mul_xi", "fq2_inv"]


@pytest.mark.parametrize("name", FQ2_UNARY)
def test_fq2_unary_matches_reference(name):
    rng = random.Random(1100 + len(name))
    a = _rand(rng, (BATCH, 2), 401)
    a[0] = 0  # inv(0) == 0 on both
    want = getattr(jtowers, name)(jnp.asarray(a))
    _same(getattr(towers, name)(_t(a)), want)


def test_fq2_mul_scalar_matches_reference():
    rng = random.Random(1111)
    a = _rand(rng, (BATCH, 2), 401)
    s = _rand(rng, (BATCH,), 401)
    want = jtowers.fq2_mul_scalar(jnp.asarray(a), jnp.asarray(s))
    _same(towers.fq2_mul_scalar(_t(a), _t(s)), want)


@pytest.mark.parametrize("name", ["fq12_add", "fq12_sub"])
def test_fq12_binary_matches_reference(name):
    rng = random.Random(1200 + len(name))
    a = _rand(rng, (BATCH, 12), 382)
    b = _rand(rng, (BATCH, 12), 382)
    want = getattr(jtowers, name)(jnp.asarray(a), jnp.asarray(b))
    _same(getattr(towers, name)(_t(a), _t(b)), want)


def test_fq12_conjugate_matches_reference():
    rng = random.Random(1210)
    a = _rand(rng, (BATCH, 12), 382)
    _same(towers.fq12_conjugate(_t(a)),
          jtowers.fq12_conjugate(jnp.asarray(a)))


def test_fq12_is_one_and_eq_match_reference():
    """Verdicts on the identity, on another representative of it (one
    limb pattern + p), on a random element, and on equal values held in
    different loose limbs."""
    rng = random.Random(1220)
    one = np.asarray(jtowers.fq12_one((BATCH,))).copy()
    one[1, 0] = fq._int_to_limbs_np(fq.limbs_to_int(one[1, 0]) + fq.P)
    one[2] = _rand(rng, (12,), 382)
    got = towers.fq12_is_one(_t(one))
    want = np.asarray(jtowers.fq12_is_one(jnp.asarray(one)))
    assert got.tolist() == want.tolist() == [True, True, False]
    a = _rand(rng, (BATCH, 12), 382)
    b = a.copy()
    b[0, 3] = fq._int_to_limbs_np(fq.limbs_to_int(a[0, 3]) + fq.P)
    b[1, 7] = _rand(rng, (), 382)
    got = towers.fq12_eq(_t(a), _t(b))
    want = np.asarray(jtowers.fq12_eq(jnp.asarray(a), jnp.asarray(b)))
    assert got.tolist() == want.tolist()
    assert want.tolist() == [True, a[1, 7].tolist() == b[1, 7].tolist(),
                             True]


def test_fq12_component_views_match_reference():
    rng = random.Random(1230)
    a = _rand(rng, (BATCH, 12), 382)
    want = jtowers.fq12_to_components(jnp.asarray(a))
    got = towers.fq12_to_components(_t(a))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _same(g, w)
    comps = [_rand(rng, (BATCH, 2), 382) for _ in range(6)]
    _same(towers.fq12_from_components([_t(c) for c in comps]),
          jtowers.fq12_from_components(
              [jnp.asarray(c) for c in comps]))


def test_fq12_from_tower_components_matches_reference():
    rng = random.Random(1240)
    c00, c11, c12 = (_rand(rng, (BATCH, 2), 382) for _ in range(3))
    want = jtowers.fq12_from_tower_components(
        jnp.asarray(c00), jnp.asarray(c11), jnp.asarray(c12))
    _same(towers.fq12_from_tower_components(_t(c00), _t(c11), _t(c12)),
          want)


def test_gamma_constants_equal_the_reference():
    assert towers._XI == TO.Fq2(1, 1)
    for n in (1, 2, 3):
        got = [(g.c0, g.c1) for g in towers._GAMMA[n]]
        assert got == [(g.c0, g.c1) for g in jtowers._GAMMA[n]]
    x = TO.Fq2(3, 5)
    assert towers._fq2_pow_int(x, 1234567) == x.pow(1234567)
    j = jtowers._fq2_pow_int(JO.Fq2(3, 5), 1234567)
    assert (towers._fq2_pow_int(x, 1234567).c0,
            towers._fq2_pow_int(x, 1234567).c1) == (j.c0, j.c1)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fq12_frobenius_matches_reference(n):
    rng = random.Random(1250 + n)
    a = _rand(rng, (BATCH, 12), 382)
    want = (lambda x: jtowers.fq12_frobenius(x, n))(jnp.asarray(a))
    _same(towers.fq12_frobenius(_t(a), n), want)


def _fq6(rng):
    return tuple(_rand(rng, (BATCH, 2), 382) for _ in range(3))


def test_fq6_mul_and_mul_by_v_match_reference():
    rng = random.Random(1260)
    a, b = _fq6(rng), _fq6(rng)
    want = jtowers._fq6_mul(tuple(map(jnp.asarray, a)),
                                     tuple(map(jnp.asarray, b)))
    got = towers._fq6_mul(tuple(map(_t, a)), tuple(map(_t, b)))
    for g, w in zip(got, want):
        _same(g, w)
    want = jtowers._fq6_mul_by_v(tuple(map(jnp.asarray, a)))
    for g, w in zip(towers._fq6_mul_by_v(tuple(map(_t, a))), want):
        _same(g, w)


def test_fq6_inv_matches_reference():
    rng = random.Random(1270)
    a = _fq6(rng)
    want = jtowers._fq6_inv(tuple(map(jnp.asarray, a)))
    for g, w in zip(towers._fq6_inv(tuple(map(_t, a))), want):
        _same(g, w)


def test_fq12_inv_matches_reference_and_the_oracle():
    rng = random.Random(1280)
    a = _rand(rng, (BATCH, 12), 382)
    want = np.asarray(jtowers.fq12_inv(jnp.asarray(a)))
    got = towers.fq12_inv(_t(a))
    _same(got, want)
    for i in range(BATCH):
        x = towers.fq12_to_oracle(a[i])
        assert towers.fq12_to_oracle(got[i]) == x.inverse()


def _rand_oracle_fq12(rng):
    def f2():
        return (rng.randrange(TO.P), rng.randrange(TO.P))

    vals = [f2() for _ in range(6)]
    port = TO.Fq12(TO.Fq6(*(TO.Fq2(*v) for v in vals[:3])),
                   TO.Fq6(*(TO.Fq2(*v) for v in vals[3:])))
    ref = JO.Fq12(JO.Fq6(*(JO.Fq2(*v) for v in vals[:3])),
                  JO.Fq6(*(JO.Fq2(*v) for v in vals[3:])))
    return port, ref


def _fq12_ints(x):
    return [(c.c0, c.c1) for half in (x.c0, x.c1)
            for c in (half.c0, half.c1, half.c2)]


def test_oracle_conversions_both_ways():
    """From the oracle: the same limbs as the JAX converters, at a batch
    shape; to the oracle: the same tower element from the same limbs
    (loose ones included), and the round trip."""
    rng = random.Random(1290)
    for _ in range(BATCH):
        x, jx = _rand_oracle_fq12(rng)
        got = towers.fq12_from_oracle(x, (2,), device="cpu")
        _same(got, jtowers.fq12_from_oracle(jx, (2,)))
        assert towers.fq12_to_oracle(got[1]) == x
        y, jy = TO.Fq2(rng.randrange(TO.P), rng.randrange(TO.P)), None
        jy = JO.Fq2(y.c0, y.c1)
        got2 = towers.fq2_from_oracle(y, (2,), device="cpu")
        _same(got2, jtowers.fq2_from_oracle(jy, (2,)))
        assert towers.fq2_to_oracle(got2[0]) == y
    loose = _rand(rng, (BATCH, 12), 401)
    for row in loose:
        assert _fq12_ints(towers.fq12_to_oracle(_t(row))) == _fq12_ints(
            jtowers.fq12_to_oracle(row))
    loose2 = _rand(rng, (BATCH, 2), 401)
    for row in loose2:
        a, b = towers.fq2_to_oracle(_t(row)), jtowers.fq2_to_oracle(row)
        assert (a.c0, a.c1) == (b.c0, b.c1)
