"""The codec's field arithmetic in the port (consensus_specs_tpu_torch/
ops/fq.py, ops/towers.py, ops/codec.py) against the JAX package's, raw
limbs equal (tolerance 0), on the CPU.

Inputs are made from numpy seeds: loose Fq limbs below 2^401 (the JAX
package's loose bound) or 2^382 for the Fq2 products, canonical residues
for the codec's field functions, with zeros, p - 1 and non-residues among
them. The codec's field functions run at N <= 8. The JAX side runs the
bodies of its jitted codec kernels eagerly (``__wrapped__``), with each
``fq.pow_fixed`` chain jitted on its own (one compile per shape and
exponent): the integer results are the kernels', and compiling a whole
kernel of square-root chains takes the XLA CPU compiler minutes.
"""
import functools

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import codec as jcodec  # noqa: E402
from consensus_specs_tpu.ops import fq as jfq  # noqa: E402
from consensus_specs_tpu.ops import towers as jtowers  # noqa: E402
from consensus_specs_tpu.utils.bls12_381 import P  # noqa: E402
from consensus_specs_tpu_torch.ops import codec, fq, towers  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

L = fq.NUM_LIMBS


_JAX_POW_FIXED = jfq.pow_fixed


@functools.partial(jax.jit, static_argnums=1)
def _jax_pow_fixed_jitted(a, bits):
    return _JAX_POW_FIXED(a, list(bits))


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side's Montgomery product on its jnp uint64 lowering, its
    exponentiation chains compiled once per shape and exponent."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.setattr(jfq, "pow_fixed",
                        lambda a, bits: _jax_pow_fixed_jitted(a, tuple(bits)))


def _rand_loose(rng, shape, bits=401):
    """Random loose values below 2^bits as (..., 15) uint64 limbs."""
    limbs = rng.integers(0, 1 << 28, size=tuple(shape) + (L,), dtype=np.int64)
    full, rest = divmod(bits, 28)
    limbs[..., full] &= (1 << rest) - 1
    limbs[..., full + 1:] = 0
    return limbs.astype(np.uint64)


def _canon(rng, shape):
    """Random canonical residues (< p): limbs 0..12 uniform, limb 13 below
    p's, limb 14 zero."""
    limbs = _rand_loose(rng, shape, bits=28 * 13)
    limbs[..., 13] = rng.integers(0, int(fq.P_LIMBS[13]), size=shape)
    return limbs


def _ints_to_limbs(vals):
    return np.stack([fq._int_to_limbs_np(v) for v in vals])


def _t(x):
    return fq.limbs_from_numpy(x, "cpu")


def _np(x):
    x = x.numpy()
    return x.astype(np.uint64) if x.dtype == np.int64 else x


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(got, want):
    """Raw equality of a port result and a JAX result, tuples elementwise."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape
    assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# ops/fq.py and the Fq2 subset of ops/towers.py
# ---------------------------------------------------------------------------


def _fq_edge_batch(rng):
    """(12, L) loose values: random, zero, p, 2p, p - 1, 1, and equal
    residues in two representations."""
    a = _rand_loose(rng, (12,))
    a[0] = 0
    a[1] = fq._int_to_limbs_np(P)
    a[2] = fq._int_to_limbs_np(2 * P)
    a[3] = fq._int_to_limbs_np(P - 1)
    a[4] = fq.ONE_MONT
    a[5] = fq._int_to_limbs_np(fq.limbs_to_int(a[6]) + P)
    return a


@pytest.mark.parametrize("fn", ["neg", "canonical", "is_zero", "_geq_p"])
def test_fq_unary_matches_reference(fn):
    a = _fq_edge_batch(np.random.default_rng(1001))
    _same(getattr(fq, fn)(_t(a)), getattr(jfq, fn)(jnp.asarray(a)))


def test_fq_sub_p_matches_reference():
    """_sub_p on carried values in [p, 2p), as canonical feeds it."""
    rng = np.random.default_rng(1002)
    a = _ints_to_limbs([P + fq.limbs_to_int(x) for x in _canon(rng, (8,))]
                       + [P, 2 * P - 1])
    _same(fq._sub_p(_t(a)), jfq._sub_p(jnp.asarray(a)))


def test_fq_eq_select_add_many_match_reference():
    rng = np.random.default_rng(1003)
    a = _fq_edge_batch(rng)
    b = a.copy()
    b[6:] = _rand_loose(rng, (6,))
    b[7] = fq._int_to_limbs_np(fq.limbs_to_int(a[7]) + 2 * P)  # equal mod p
    _same(fq.eq(_t(a), _t(b)), jfq.eq(*_j(a, b)))
    cond = rng.random(12) < 0.5
    _same(fq.select(torch.from_numpy(cond), _t(a), _t(b)),
          jfq.select(*_j(cond, a, b)))
    terms = [_rand_loose(rng, (4, 3)) for _ in range(5)]
    _same(fq.add_many([_t(x) for x in terms]),
          jfq.add_many([jnp.asarray(x) for x in terms]))


@pytest.mark.parametrize("bits", [[1], [1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1],
                                  jfq._P_MINUS_2_BITS])
def test_fq_pow_fixed_matches_reference(bits):
    a = _fq_edge_batch(np.random.default_rng(1004))[:6]
    _same(fq.pow_fixed(_t(a), bits), _JAX_POW_FIXED(jnp.asarray(a), bits))


def test_fq_inv_and_const_match_reference():
    a = _fq_edge_batch(np.random.default_rng(1005))[:4]
    got = fq.inv(_t(a))
    _same(got, jfq.inv(jnp.asarray(a)))
    assert fq.from_mont_limbs(_np(got)[0]) == 0  # inv(0) == 0
    for x in (0, 7, P - 1, P + 3, -5):
        _same(fq.const(x, (2, 3), device="cpu"), jfq.const(x, (2, 3)))


@pytest.mark.parametrize("fn", ["fq2_add", "fq2_sub", "fq2_mul", "fq2_eq"])
def test_fq2_binary_matches_reference(fn):
    rng = np.random.default_rng(1100 + len(fn))
    a = _rand_loose(rng, (6, 2), bits=382)
    b = _rand_loose(rng, (6, 2), bits=382)
    b[0] = a[0]
    b[1, 0] = fq._int_to_limbs_np(fq.limbs_to_int(a[1, 0]) + P)
    b[1, 1] = a[1, 1]
    _same(getattr(towers, fn)(_t(a), _t(b)),
          getattr(jtowers, fn)(*_j(a, b)))


@pytest.mark.parametrize("fn", ["fq2_neg", "fq2_square", "fq2_canonical",
                                "fq2_is_zero"])
def test_fq2_unary_matches_reference(fn):
    a = _rand_loose(np.random.default_rng(1200 + len(fn)), (6, 2), bits=382)
    a[0] = 0
    a[1, 0] = fq._int_to_limbs_np(P)
    a[1, 1] = 0
    _same(getattr(towers, fn)(_t(a)), getattr(jtowers, fn)(jnp.asarray(a)))


def test_fq2_select_const_match_reference():
    rng = np.random.default_rng(1300)
    a = _rand_loose(rng, (5, 2), bits=382)
    b = _rand_loose(rng, (5, 2), bits=382)
    cond = np.array([True, False, True, True, False])
    _same(towers.fq2_select(torch.from_numpy(cond), _t(a), _t(b)),
          jtowers.fq2_select(*_j(cond, a, b)))
    _same(towers.fq2_const(3, P - 1, (4,), device="cpu"),
          jtowers.fq2_const(3, P - 1, (4,)))


# ---------------------------------------------------------------------------
# ops/codec.py field functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_associative_scan_tree_matches_jax(n):
    """The pairing tree of jax.lax.associative_scan, both directions: the
    loose limbs of every prefix product are equal, not just their
    residues."""
    x = _rand_loose(np.random.default_rng(1400 + n), (n,))
    want = jax.jit(lambda v: (
        jax.lax.associative_scan(jfq.mont_mul, v, axis=0),
        jax.lax.associative_scan(jfq.mont_mul, v, axis=0, reverse=True),
    ))(jnp.asarray(x))
    got = (codec._associative_scan(fq.mont_mul, _t(x)),
           codec._associative_scan(fq.mont_mul, _t(x).flip(0)).flip(0))
    _same(got, want)


@pytest.mark.parametrize("n", [1, 8])
def test_fq_batch_inverse_raw_matches_reference(n):
    """Raw limbs of the ladder, zero lanes and p - 1 included."""
    rng = np.random.default_rng(1500 + n)
    a = _canon(rng, (n,))
    a[0] = fq.to_mont_int(P - 1)
    if n > 2:
        a[2] = 0
    got = codec.fq_batch_inverse(a, device="cpu")
    assert np.array_equal(got, np.asarray(jcodec._fq_batch_inverse(
        jnp.asarray(a))))
    for v, inv in zip(a, got):
        x = fq.from_mont_limbs(v)
        assert fq.from_mont_limbs(inv) == (pow(x, P - 2, P) if x else 0)


def _fq2_cases(rng):
    """(8, 2, L) Montgomery Fq2 values: random (residues and non-residues),
    a square, b == 0 lanes (a residue, a non-residue, zero) and a == 0."""
    v = _canon(rng, (8, 2))
    sq = jcodec._fq2_const_np(jcodec.O.Fq2(5, 9).square())
    v[1] = sq
    v[2, 1] = 0
    v[3, 1] = 0
    v[3, 0] = fq.to_mont_int(P - 1)  # -1: no Fq root, root (0, 1)
    v[4] = 0
    v[5, 0] = 0
    return v


def test_fq2_sqrt_matches_reference():
    v = _fq2_cases(np.random.default_rng(1600))
    r, ok = codec.fq2_sqrt_batch(v, device="cpu")
    want_r, want_ok = jcodec._fq2_sqrt(jnp.asarray(v))
    assert np.array_equal(r, np.asarray(want_r))
    assert np.array_equal(ok, np.asarray(want_ok))
    assert ok.any() and not ok.all()


def test_g1_decode_matches_reference():
    """Random raw x (< p): about half of them on the curve."""
    x_raw = _canon(np.random.default_rng(1700), (8,))
    x_raw[3] = 0
    _same(codec._g1_decode(_t(x_raw)),
          jcodec._g1_decode_kernel.__wrapped__(jnp.asarray(x_raw)))


def test_g2_decode_matches_reference():
    x_raw = _canon(np.random.default_rng(1800), (8, 2))
    x_raw[3, 1] = 0
    _same(codec._g2_decode(_t(x_raw)),
          jcodec._g2_decode_kernel.__wrapped__(jnp.asarray(x_raw)))


def test_sswu_map_matches_reference():
    """Eight field draws (four messages' worth), u = 0 included: tv2 == 0
    takes the exceptional x1."""
    u = _canon(np.random.default_rng(1900), (8, 2))
    u[5] = 0
    got = codec._sswu_map(_t(u))
    _same(got, jcodec._sswu_map_kernel.__wrapped__(jnp.asarray(u)))
    assert bool(got[2].all())


def test_proj_to_affine_sgn0_demont_match_reference():
    rng = np.random.default_rng(2000)
    X, Y, Z = (_rand_loose(rng, (4, 2), bits=382) for _ in range(3))
    Z[2] = 0  # inv(0) == 0 absorbs infinity
    _same(codec._proj_to_affine(_t(X), _t(Y), _t(Z)),
          jcodec._proj_to_affine_kernel.__wrapped__(*_j(X, Y, Z)))
    v = _fq2_cases(rng)
    _same(codec._sgn0(_t(v)), jcodec._sgn0(jnp.asarray(v)))
    _same(codec._demont(_t(v[:, 0])), jcodec._demont(jnp.asarray(v[:, 0])))
    _same(codec._gprime(_t(v)), jcodec._gprime(jnp.asarray(v)))


def test_limb_decode_and_compares_match_reference():
    rng = np.random.default_rng(2100)
    raw = rng.integers(0, 256, size=(6, 48), dtype=np.uint8)
    raw[0] = np.frombuffer((P - 1).to_bytes(48, "big"), dtype=np.uint8)
    raw[1] = np.frombuffer(P.to_bytes(48, "big"), dtype=np.uint8)
    limbs = codec.bytes_be_to_limbs(raw)
    assert np.array_equal(limbs, jcodec.bytes_be_to_limbs(raw))
    assert [fq.limbs_to_int(x) for x in limbs] == [
        int.from_bytes(r.tobytes(), "big") for r in raw]
    assert np.array_equal(codec._limbs_lt_const(limbs, codec._P_LIMBS),
                          jcodec._limbs_lt_const(limbs, jcodec._P_LIMBS))
    y = _canon(rng, (6, 2))
    y[2, 1] = 0
    assert np.array_equal(codec._sign_is_large_fq2(y),
                          jcodec._sign_is_large_fq2(y))
    assert np.array_equal(codec._sign_is_large_fq(y[:, 0]),
                          jcodec._sign_is_large_fq(y[:, 0]))
    for n in (1, 3, 4, 5):
        a = limbs[:n]
        assert np.array_equal(codec._pad_batch(a), jcodec._pad_batch(a))
