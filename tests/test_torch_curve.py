"""The port's Jacobian curve arithmetic (consensus_specs_tpu_torch/ops/
curve.py) against the JAX package's ops/curve.py on the CPU: ``double``
and ``add_mixed`` on G1 and G2 over every special case (infinity, T == Q,
T == -Q), raw limbs equal (tolerance 0) and the affine points the
oracle's; ``scalar_mul_fixed`` on a 16-bit scalar limb for limb; and the
full r-bit G1 subgroup check against the exact-int oracle.

Points are made from seeded scalars with the JAX package's jax-free
oracle (utils/bls12_381.py); Jacobian inputs carry a random z.
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from consensus_specs_tpu.ops import curve as jcurve  # noqa: E402
from consensus_specs_tpu.ops import fq as jfq  # noqa: E402
from consensus_specs_tpu.utils import bls12_381 as O  # noqa: E402
from consensus_specs_tpu_torch.ops import curve, fq  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side's Montgomery product on its jnp uint64 lowering."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")


def _fe(x, g2):
    if g2:
        return np.stack([jfq.to_mont_int(x.c0), jfq.to_mont_int(x.c1)])
    return jfq.to_mont_int(x.n)


def _zero(g2):
    return np.zeros((2, fq.NUM_LIMBS) if g2 else (fq.NUM_LIMBS,), np.uint64)


def _jacobian(aff, z, g2):
    """Affine oracle point -> Jacobian limbs (x z^2, y z^3, z)."""
    if aff is None:
        return _zero(g2), _zero(g2), _zero(g2)
    x, y = aff
    return _fe(x * z * z, g2), _fe(y * z * z * z, g2), _fe(z, g2)


def _decode(limbs, g2):
    """Limbs -> the JAX package's oracle field element."""
    limbs = limbs.numpy()
    if g2:
        return O.Fq2(fq.from_mont_limbs(limbs[0]), fq.from_mont_limbs(limbs[1]))
    return O.Fq(fq.from_mont_limbs(limbs))


def _affine(pt, i, g2):
    """Row i of a Jacobian point tensor dict -> oracle affine (None at
    infinity)."""
    if bool(fq.is_zero(pt["z"][i]).all()):
        return None
    z = _decode(pt["z"][i], g2)
    zi = z.inverse()
    return (_decode(pt["x"][i], g2) * zi * zi,
            _decode(pt["y"][i], g2) * zi * zi * zi)


def _gen(g2):
    return O.G2_GEN if g2 else O.G1_GEN


def _rand_z(rng, g2):
    if g2:
        return O.Fq2(rng.randrange(1, O.P), rng.randrange(O.P))
    return O.Fq(rng.randrange(1, O.P))


def _batch(rows):
    return {k: np.stack([r[j] for r in rows]) for j, k in enumerate("xyz")}


def _torch_pt(pt):
    return {k: fq.limbs_from_numpy(v, "cpu") for k, v in pt.items()}


def _same_pt(got, want):
    for k in "xyz":
        assert np.array_equal(got[k].numpy().astype(np.uint64),
                              np.asarray(want[k])), k


def _ops(g2):
    return (curve.FQ2_OPS, jcurve.FQ2_OPS) if g2 else (curve.FQ_OPS,
                                                         jcurve.FQ_OPS)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_double_matches_reference_and_oracle(g2):
    rng = random.Random(31 + g2)
    ks = [rng.randrange(1, O.R) for _ in range(3)]
    affs = [O.ec_to_affine(O.ec_mul(_gen(g2), k)) for k in ks] + [None]
    pt = _batch([_jacobian(a, _rand_z(rng, g2), g2) for a in affs])
    F, JF = _ops(g2)
    got = curve.double(F, _torch_pt(pt))
    _same_pt(got, jcurve.double(JF, {k: jnp.asarray(v)
                                      for k, v in pt.items()}))
    for i, k in enumerate(ks):
        assert _affine(got, i, g2) == O.ec_to_affine(
            O.ec_mul(_gen(g2), 2 * k))
    assert _affine(got, 3, g2) is None


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_add_mixed_matches_reference_and_oracle_in_every_case(g2):
    """Rows: generic T + Q, T == Q (doubles), T == -Q (infinity), T at
    infinity (gives Q)."""
    rng = random.Random(41 + g2)
    a, b = rng.randrange(1, O.R), rng.randrange(1, O.R)
    t_scalars = [a, b, O.R - b, None]
    q = O.ec_to_affine(O.ec_mul(_gen(g2), b))
    rows = [_jacobian(None if k is None else
                      O.ec_to_affine(O.ec_mul(_gen(g2), k)),
                      _rand_z(rng, g2), g2) for k in t_scalars]
    pt = _batch(rows)
    qx = np.stack([_fe(q[0], g2)] * 4)
    qy = np.stack([_fe(q[1], g2)] * 4)
    F, JF = _ops(g2)
    got = curve.add_mixed(F, _torch_pt(pt), fq.limbs_from_numpy(qx, "cpu"),
                          fq.limbs_from_numpy(qy, "cpu"))
    want = jcurve.add_mixed(JF, {k: jnp.asarray(v) for k, v in pt.items()},
                            jnp.asarray(qx), jnp.asarray(qy))
    _same_pt(got, want)
    expect = [O.ec_to_affine(O.ec_mul(_gen(g2), (a + b) % O.R)),
              O.ec_to_affine(O.ec_mul(_gen(g2), 2 * b)), None, q]
    for i, e in enumerate(expect):
        assert _affine(got, i, g2) == e, i


def _scalar_mul(rng, g2):
    """(port result, its bits, the two scalars, qx, qy) for 2 random
    points and a random 16-bit scalar."""
    scalar = rng.randrange(1 << 15, 1 << 16)
    bits = [int(b) for b in bin(scalar)[2:]]
    ks = [rng.randrange(1, O.R) for _ in range(2)]
    affs = [O.ec_to_affine(O.ec_mul(_gen(g2), k)) for k in ks]
    qx = np.stack([_fe(p[0], g2) for p in affs])
    qy = np.stack([_fe(p[1], g2) for p in affs])
    got = curve.scalar_mul_fixed(_ops(g2)[0], fq.limbs_from_numpy(qx, "cpu"),
                                 fq.limbs_from_numpy(qy, "cpu"), bits)
    for i, k in enumerate(ks):
        assert _affine(got, i, g2) == O.ec_to_affine(
            O.ec_mul(_gen(g2), k * scalar))
    return got, bits, qx, qy


def test_scalar_mul_fixed_short_bits_matches_reference_g1():
    """Limb for limb against the JAX package's lax.scan (jitted, as
    its own tests run it), and the oracle's k*P."""
    got, bits, qx, qy = _scalar_mul(random.Random(51), False)
    want = jax.jit(lambda x, y: jcurve.scalar_mul_fixed(
        jcurve.FQ_OPS, x, y, bits))(jnp.asarray(qx), jnp.asarray(qy))
    _same_pt(got, want)


def test_scalar_mul_fixed_short_bits_matches_oracle_g2():
    """On G2 against the oracle's k*Q (the same loop as G1's; the JAX
    scan's G2 body compiles for minutes on the CPU, and its doubling and
    mixed addition are held limb for limb above)."""
    _scalar_mul(random.Random(52), True)


def _off_subgroup_g1(rng):
    """A G1 curve point outside the order-r subgroup."""
    while True:
        x = O.Fq(rng.randrange(O.P))
        y2 = x * x * x + O.B_G1
        y = O.fq_sqrt(y2.n)
        if y is None:
            continue
        pt = O.ec_from_affine((x, O.Fq(y)))
        if not O.is_in_g1_subgroup(pt):
            return x, O.Fq(y)


def test_g1_subgroup_check_over_r_against_the_oracle():
    """r*P by the static bits of r: z == 0 on subgroup points, z != 0 on a
    curve point outside the subgroup, as the oracle decides."""
    rng = random.Random(61)
    affs = [O.ec_to_affine(O.ec_mul(O.G1_GEN, rng.randrange(1, O.R)))
            for _ in range(2)] + [_off_subgroup_g1(rng)]
    assert curve.subgroup_check_bits() == jcurve.subgroup_check_bits()
    qx = np.stack([_fe(p[0], False) for p in affs])
    qy = np.stack([_fe(p[1], False) for p in affs])
    out = curve.scalar_mul_fixed(curve.FQ_OPS, fq.limbs_from_numpy(qx, "cpu"),
                                 fq.limbs_from_numpy(qy, "cpu"),
                                 curve.subgroup_check_bits())
    at_infinity = curve.is_infinity(curve.FQ_OPS, out).tolist()
    assert at_infinity == [O.is_in_g1_subgroup(O.ec_from_affine(p))
                           for p in affs] == [True, True, False]
