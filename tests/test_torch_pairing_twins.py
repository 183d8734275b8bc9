"""The port's pairing (consensus_specs_tpu_torch/ops/pairing.py) against
the JAX package on the CPU: one doubling and one addition step of the
Miller loop limb for limb against the JAX functions (tolerance 0); the
whole Miller loop on 2 rows against the JAX package's exact-int oracle
(``utils/bls12_381.miller_loop``) up to the documented Fq2 subfield
factor (the ratio is fixed by Frobenius^2, as tests/test_ops_pairing.py
checks the JAX loop); ``pairing_product_is_one`` true and false; and
``final_exp_is_one`` against the JAX backend's verdict on valid and
corrupted f (``final_exp_is_one_full`` is held against it in
tests/test_torch_pairing_full.py). The JAX twin of the whole loop compiles for minutes on the
CPU, so the limb-for-limb run of the whole loop is marked ``slow``, as
the JAX package marks its own.
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import bls_backend as jbls  # noqa: E402
from consensus_specs_tpu.ops import fq as jfq  # noqa: E402
from consensus_specs_tpu.ops import pairing as jpairing  # noqa: E402
from consensus_specs_tpu.ops import towers as jtowers  # noqa: E402
from consensus_specs_tpu.utils import bls12_381 as O  # noqa: E402
from consensus_specs_tpu_torch.ops import fq, pairing, towers  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side's Montgomery product on its jnp uint64 lowering, and
    its final exponentiation on the exact-int host route."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_FINAL", "host")


def g1_points(ks):
    xs, ys = [], []
    for k in ks:
        x, y = O.ec_to_affine(O.ec_mul(O.G1_GEN, k))
        xs.append(jfq.to_mont_int(x.n))
        ys.append(jfq.to_mont_int(y.n))
    return np.stack(xs), np.stack(ys)


def g2_points(ks):
    xs, ys = [], []
    for k in ks:
        x, y = O.ec_to_affine(O.ec_mul(O.G2_GEN, k))
        xs.append(np.stack([jfq.to_mont_int(x.c0), jfq.to_mont_int(x.c1)]))
        ys.append(np.stack([jfq.to_mont_int(y.c0), jfq.to_mont_int(y.c1)]))
    return np.stack(xs), np.stack(ys)


def neg_g1(k):
    x, y = O.ec_to_affine(O.ec_neg(O.ec_mul(O.G1_GEN, k)))
    return jfq.to_mont_int(x.n), jfq.to_mont_int(y.n)


def _t(x):
    return fq.limbs_from_numpy(x, "cpu")


def _same(got, want):
    assert np.array_equal(got.numpy().astype(np.uint64), np.asarray(want))


def _jacobian_t(rng, ks):
    """Jacobian G2 points (random z) as (numpy limbs dict, oracle points)."""
    pts = {"x": [], "y": [], "z": []}
    for k in ks:
        x, y = O.ec_to_affine(O.ec_mul(O.G2_GEN, k))
        z = O.Fq2(rng.randrange(1, O.P), rng.randrange(O.P))
        for name, v in (("x", x * z * z), ("y", y * z * z * z), ("z", z)):
            pts[name].append(np.stack([jfq.to_mont_int(v.c0),
                                       jfq.to_mont_int(v.c1)]))
    return {k: np.stack(v) for k, v in pts.items()}


def test_dbl_step_matches_reference():
    rng = random.Random(71)
    T = _jacobian_t(rng, [3, 1000003])
    px, py = g1_points([5, 7])
    line, T2 = pairing._dbl_step({k: _t(v) for k, v in T.items()}, _t(px),
                                 _t(py))
    jline, jT2 = jpairing._dbl_step({k: jnp.asarray(v) for k, v in T.items()},
                                    jnp.asarray(px), jnp.asarray(py))
    _same(line, jline)
    for k in "xyz":
        _same(T2[k], jT2[k])


def test_add_step_matches_reference():
    rng = random.Random(72)
    T = _jacobian_t(rng, [3, 1000003])
    qx, qy = g2_points([11, 13])
    px, py = g1_points([5, 7])
    line, T3 = pairing._add_step({k: _t(v) for k, v in T.items()}, _t(qx),
                                 _t(qy), _t(px), _t(py))
    jline, jT3 = jpairing._add_step(
        {k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(qx),
        jnp.asarray(qy), jnp.asarray(px), jnp.asarray(py))
    _same(line, jline)
    for k in "xyz":
        _same(T3[k], jT3[k])


def test_miller_loop_matches_the_oracle_up_to_a_subfield_factor():
    ks_g1, ks_g2 = [1, 7], [1, 11]
    px, py = g1_points(ks_g1)
    qx, qy = g2_points(ks_g2)
    f = pairing.miller_loop(_t(qx), _t(qy), _t(px), _t(py))
    assert f.shape == (2, 12, fq.NUM_LIMBS)
    for i in range(2):
        got = jtowers.fq12_to_oracle(f[i].numpy().astype(np.uint64))
        expect = O.miller_loop(O.ec_to_affine(O.ec_mul(O.G2_GEN, ks_g2[i])),
                               O.ec_to_affine(O.ec_mul(O.G1_GEN, ks_g1[i])))
        ratio = got * expect.inverse()
        assert ratio.frobenius().frobenius() == ratio, i
        # and the port's converter reads the same element
        assert towers.fq12_to_oracle(f[i]) == towers.fq12_to_oracle(
            f[i].numpy())


def _pairs(a, b_g1):
    """e(b_g1 P, Q) * e(-P, a Q): one at a time and each row of the pair."""
    px1, py1 = g1_points([b_g1])
    qx1, qy1 = g2_points([1])
    nx, ny = neg_g1(1)
    qx2, qy2 = g2_points([a])
    return [(_t(px1), _t(py1), _t(qx1), _t(qy1)),
            (_t(nx[None]), _t(ny[None]), _t(qx2), _t(qy2))]


def test_pairing_product_is_one_true_and_false():
    """e(aP, Q) * e(-P, aQ) == 1 holds; with (a+1)P in place of aP it
    does not."""
    a = 5
    assert pairing.pairing_product_is_one(_pairs(a, a)).tolist() == [True]
    assert pairing.pairing_product_is_one(_pairs(a, a + 1)).tolist() == [
        False]


def test_final_exp_is_one_matches_the_reference_verdict():
    """f = the two Miller outputs' product (valid) and f times a random
    element (corrupted): the structured final exponentiation's verdicts
    equal the JAX backend's exact-int ``_final_exp_is_one``."""
    rng = random.Random(73)
    pairs = _pairs(9, 9)
    fs = [pairing.miller_loop(qx, qy, px, py) for px, py, qx, qy in pairs]
    f = towers.fq12_mul(fs[0], fs[1])
    noise = np.stack([jfq.to_mont_int(rng.randrange(O.P)) for _ in range(12)])
    bad = towers.fq12_mul(f, _t(noise[None]))
    batch = torch.cat([f, bad])
    got = pairing.final_exp_is_one(batch).tolist()
    want = [jbls._final_exp_is_one(
        [fq.from_mont_limbs(row[j]) for j in range(12)])
        for row in batch.numpy()]
    assert got == want == [True, False]


@pytest.mark.slow
def test_whole_miller_loop_matches_the_jax_twin_limb_for_limb():
    px, py = g1_points([1, 7])
    qx, qy = g2_points([1, 11])
    got = pairing.miller_loop(_t(qx), _t(qy), _t(px), _t(py))
    want = jax.jit(jpairing.miller_loop)(qx, qy, px, py)
    _same(got, want)
