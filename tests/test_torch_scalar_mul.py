"""The scalar-multiplication kernel (ops/cuda_tower.scalar_mul:
csrc/scalar_mul.cu over csrc/tower.cuh) on the CPU, where no kernel can
run:

- a replay of the kernel's operation order in Python integers (tower.cuh's
  fq_lin, Montgomery product, canonical form and zero tests; the doubling
  at every bit, and at a set bit only the branch of the mixed addition
  that the JAX package's selects keep), held to the JAX package's jitted
  ``curve.scalar_mul_fixed`` limb for limb (tolerance 0) over r's bits on
  G1 rows in and off the subgroup, and on every special case of the mixed
  addition: a G1 point of order 3 (Q, then -Q, met mid-loop) against JAX,
  a G2 point of order 13 against the port's plain loop and the oracle,
  and the G2 doubling and mixed addition against JAX's steps at
  every accumulator that point's ladder reaches (infinity, Q, -Q and
  generic points), every branch of the G2 instantiation;
- doubling the point at infinity leaves non-zero multiples of p in X and
  Y, so every infinity test is mod p;
- the dispatcher on CPU tensors runs the plain loop and launches nothing;
  the wrapper refuses what the kernel does not take;
- the packed bit words hold every bit, the first one included;
- ``cuda_tower.MONTS`` against the plain version's products and the
  replay's, branch by branch, and the chip smoke's product count and
  dependent-path tracer on it (a select's condition included).

The kernel itself is held against the plain loop on the card in
tests/test_torch_tower_cuda.py and ``python3 chip_smoke.py``.
"""
import random
import re
from pathlib import Path

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import curve as jcurve  # noqa: E402
from consensus_specs_tpu_torch.ops import (  # noqa: E402
    cuda_fq, cuda_tower, curve, fq, towers)
from consensus_specs_tpu_torch.utils import bls12_381 as O  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

L = fq.NUM_LIMBS
CSRC = Path(cuda_tower.__file__).resolve().parent.parent / "csrc"
R_BITS = curve.subgroup_check_bits()
# a 16-bit scalar on G2, where the JAX scan compiles for minutes
SHORT_BITS = [int(b) for b in bin(0xB5A3)[2:]]


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side's Montgomery product on its jnp uint64 lowering."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")


@pytest.fixture(autouse=True)
def _counters_untouched():
    """No test here launches a kernel: every counter stays where it was."""
    cuda_tower.reset()
    yield
    assert cuda_tower.launches() == {k: 0 for k in cuda_tower.KERNELS}


def _smoke():
    import chip_smoke

    return chip_smoke


# ---------------------------------------------------------------------------
# the replay: tower.cuh's operations on lists of 15 limbs, in the CUDA
# source's order

MASK = fq.MASK
_ONE = [int(x) for x in fq.ONE_MONT]
_P = [int(x) for x in fq.P_LIMBS]
_MP1 = [int(x) for x in fq._int_to_limbs_np(fq.MP + 1)]
_R = 1 << (28 * L)
_NEG_P_INV = -pow(O.P, -1, _R) % _R
PRODUCTS = [0]


def _int(a):
    return sum(v << (28 * k) for k, v in enumerate(a))


def _limbs(v):
    return [(v >> (28 * k)) & MASK for k in range(L)]


def r_lin(a, b, sub):
    """mont.cuh fq_lin: a + (sub ? (MP + 1) + (MASK - b) : b), rippled limb
    by limb, the carry out of limb 14 dropped."""
    out, c = [], 0
    for k in range(L):
        cur = a[k] + (_MP1[k] + (MASK - b[k]) if sub else b[k]) + c
        out.append(cur & MASK)
        c = cur >> 28
    return out


def r_mul(a, b):
    """tw_mul: mont.cuh fq_mont_mul's integer (ab + mp) / 2^420, m the one
    REDC multiple below 2^420, as carried limbs (held to
    fq.mont_mul_plain below)."""
    PRODUCTS[0] += 1
    t = _int(a) * _int(b)
    return _limbs((t + (t * _NEG_P_INV % _R) * O.P) >> (28 * L))


def r_add(a, b):
    return r_lin(a, b, False)


def r_sub(a, b):
    """tw_sub: b compressed (a product by ONE_MONT), then fq_lin's sub."""
    return r_lin(a, r_mul(b, _ONE), True)


def r_canonical(a):
    """tw_canonical: a product by ONE_MONT, tw_geq_p, tw_sub_p."""
    r = r_mul(a, _ONE)
    ge, gt = True, False
    for k in reversed(range(L)):
        gt = gt or (ge and r[k] > _P[k])
        ge = ge and r[k] == _P[k]
    if not (gt or ge):
        return r
    out, borrow = [], 0
    for k in range(L):
        cur = r[k] + (1 << 28) - _P[k] - borrow
        out.append(cur & MASK)
        borrow = 1 - (cur >> 28)
    return out


class RFq:
    """tower.cuh's cv_* overloads on Fq values (lists of limbs)."""
    add, sub, mul = staticmethod(r_add), staticmethod(r_sub), \
        staticmethod(r_mul)

    @staticmethod
    def sq(a):
        return r_mul(a, a)

    @staticmethod
    def is_zero(a):
        return not any(r_canonical(a))

    @staticmethod
    def one():
        return list(_ONE)

    @staticmethod
    def zero():
        return [0] * L


class RFq2:
    """tower.cuh's cv_* overloads on Fq2 values (pairs of limb lists)."""

    @staticmethod
    def add(a, b):
        return (r_add(a[0], b[0]), r_add(a[1], b[1]))

    @staticmethod
    def sub(a, b):
        return (r_sub(a[0], b[0]), r_sub(a[1], b[1]))

    @staticmethod
    def mul(a, b):
        t0, t1 = r_mul(a[0], b[0]), r_mul(a[1], b[1])
        t2 = r_mul(r_add(a[0], a[1]), r_add(b[0], b[1]))
        return (r_sub(t0, t1), r_sub(t2, r_add(t0, t1)))

    @staticmethod
    def sq(a):
        c1 = r_mul(a[0], a[1])
        return (r_mul(r_add(a[0], a[1]), r_sub(a[0], a[1])), r_add(c1, c1))

    @staticmethod
    def is_zero(a):
        z0 = RFq.is_zero(a[0])
        z1 = RFq.is_zero(a[1])
        return z0 and z1

    @staticmethod
    def one():
        return (list(_ONE), [0] * L)

    @staticmethod
    def zero():
        return ([0] * L, [0] * L)


def r_double(F, p):
    """tw_jac_double."""
    X, Y, Z = p
    A, B = F.sq(X), F.sq(Y)
    C = F.sq(B)
    t2 = F.sub(F.sub(F.sq(F.add(X, B)), A), C)
    D = F.add(t2, t2)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.sq(E), F.add(D, D))
    c2 = F.add(C, C)
    C8 = F.add(F.add(c2, c2), F.add(c2, c2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    YZ = F.mul(Y, Z)
    return (X3, Y3, F.add(YZ, YZ))


def r_add_mixed(F, p, qx, qy, taken):
    """tw_jac_add_mixed: (the new point, or None for the p == Q branch,
    whose doubling the loop makes), the branch noted in ``taken``."""
    X, Y, Z = p
    if F.is_zero(Z):
        taken.append("inf")
        return (qx, qy, F.one())
    Z2 = F.sq(Z)
    Z3 = F.mul(Z2, Z)
    H = F.sub(F.mul(qx, Z2), X)
    Rr = F.sub(F.mul(qy, Z3), Y)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(Rr)
    if h_zero:
        taken.append("double" if r_zero else "zero")
        return None if r_zero else (F.zero(), F.zero(), F.zero())
    taken.append("add")
    H2 = F.sq(H)
    H3 = F.mul(H2, H)
    V = F.mul(X, H2)
    X3 = F.sub(F.sub(F.sq(Rr), H3), F.add(V, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(Y, H3))
    return (X3, Y3, F.mul(Z, H))


def r_scalar_mul_row(F, qx, qy, bits, taken=None, seen=None):
    """scalar_mul_kernel on one row: the bits read from the packed words;
    a doubling at every bit, the addition at a set bit, the p == Q
    branch's doubling the next pass of the loop's one doubling. ``seen``
    gets ("double", acc) before each doubling and ("add", acc) before
    each addition."""
    taken = [] if taken is None else taken
    seen = [] if seen is None else seen
    words = list(cuda_tower._scalar_words(tuple(bits)))
    acc = (F.zero(), F.zero(), F.zero())
    again, t = False, 0
    while t < len(bits):
        seen.append(("double", acc))
        acc = r_double(F, acc)
        if again:
            again = False
        elif (words[t >> 5] >> (t & 31)) & 1:
            seen.append(("add", acc))
            added = r_add_mixed(F, acc, qx, qy, taken)
            if added is None:
                again = True
                continue
            acc = added
        t += 1
    return acc


def r_scalar_mul(g2, qx, qy, bits, taken=None):
    """The kernel's rows, one after the other: (x, y, z) numpy limbs."""
    F = RFq2 if g2 else RFq
    out = []
    for x, y in zip(qx, qy):
        if g2:
            x, y = (tuple(list(map(int, c)) for c in v) for v in (x, y))
        else:
            x, y = list(map(int, x)), list(map(int, y))
        out.append(r_scalar_mul_row(F, x, y, bits, taken))
    return [np.array([row[i] for row in out], dtype=np.uint64)
            for i in range(3)]


def _same_pt(got, want):
    """Replayed (x, y, z) limbs against a point: a dict of coordinates or
    another replay's (x, y, z)."""
    for i, k in enumerate("xyz"):
        w = want[k] if isinstance(want, dict) else want[i]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.array_equal(np.asarray(got[i]), w.astype(np.uint64)), k


# ---------------------------------------------------------------------------
# points


def _rows(affs):
    return tuple(v.astype(np.uint64) for v in curve.affine_limbs(affs))


def _subgroup(rng, g2, n):
    gen = O.G2_GEN if g2 else O.G1_GEN
    return [O.ec_to_affine(O.ec_mul(gen, rng.randrange(1, O.R)))
            for _ in range(n)]


_JAX_G1 = []


def j_scalar_mul(qx, qy, bits):
    """The JAX package's curve.scalar_mul_fixed on G1, jitted with the
    bits as an argument (its scan reads them as an array), so one compile
    serves every call of 3 rows and 255 bits; shorter bit lists are padded
    with leading zeros, which double the point at infinity (z stays 0)
    and leave the result's limbs alone (held on the replay below)."""
    if not _JAX_G1:
        _JAX_G1.append(jax.jit(lambda x, y, b: jcurve.scalar_mul_fixed(
            jcurve.FQ_OPS, x, y, b)))
    padded = np.zeros(len(R_BITS), dtype=bool)
    padded[len(R_BITS) - len(bits):] = bits
    out = _JAX_G1[0](jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(padded))
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# the replay against the JAX package and the plain loop


def test_the_replays_product_is_the_plain_product():
    rng = np.random.default_rng(2200)
    a = rng.integers(0, 1 << 28, size=(16, L), dtype=np.int64)
    b = rng.integers(0, 1 << 28, size=(16, L), dtype=np.int64)
    a[:, -1] &= (1 << 10) - 1
    want = fq.mont_mul_plain(torch.from_numpy(a), torch.from_numpy(b))
    got = [r_mul(list(map(int, x)), list(map(int, y))) for x, y in zip(a, b)]
    assert np.array_equal(np.array(got), want.numpy())


def test_r_bits_replay_matches_jax_on_and_off_the_subgroup():
    """r * P over r's 255 bits on two subgroup points (the last addition
    meets -P and gives infinity) and one point off the subgroup."""
    rng = random.Random(2201)
    affs = _subgroup(rng, False, 2) + O.off_subgroup_points(
        1, 1, 2202)
    qx, qy = _rows(affs)
    taken = []
    got = r_scalar_mul(False, qx, qy, R_BITS, taken)
    _same_pt(got, j_scalar_mul(qx, qy, R_BITS))
    z_zero = [RFq.is_zero(list(map(int, z))) for z in got[2]]
    assert z_zero == [True, True, False]
    # per row: the first set bit meets infinity, the last one -P on the
    # subgroup rows; every other set bit the generic branch
    ones = sum(R_BITS)
    assert taken == (["inf"] + ["add"] * (ones - 2) + ["zero"]) * 2 + [
        "inf"] + ["add"] * (ones - 1)


@pytest.mark.parametrize("bits,branch", [([1, 0, 1], "double"),
                                         ([1, 1], "zero")])
def test_g1_special_cases_match_jax(bits, branch):
    """A G1 point Q of order 3 (3 divides the cofactor): 0b101 reaches acc
    = 4Q = Q before its last addition (the H == R == 0 branch: a doubling),
    0b11 reaches acc = 2Q = -Q (the H == 0 branch: all-zero limbs, the
    point at infinity); the other rows are a subgroup point and the point
    of order 3's negation."""
    q3 = O.point_of_order(1, 3, 2210)
    affs = [q3, (q3[0], -q3[1]), _subgroup(random.Random(2211), False, 1)[0]]
    qx, qy = _rows(affs)
    taken = []
    got = r_scalar_mul(False, qx, qy, bits, taken)
    _same_pt(got, j_scalar_mul(qx, qy, bits))
    assert taken[:sum(bits)] == ["inf"] + [branch] * (sum(bits) - 1)
    # leading zeros leave the limbs alone (j_scalar_mul pads with them)
    _same_pt(r_scalar_mul(False, qx, qy, [0] * 5 + bits), got)
    k = int("".join(map(str, bits)), 2)
    for i, aff in enumerate(affs):
        want = O.ec_mul(O.ec_from_affine(aff), k)
        z = list(map(int, got[2][i]))
        assert RFq.is_zero(z) == (want is None)


@pytest.mark.parametrize("bits,branch", [([1, 1, 1, 1], "double"),
                                         ([1, 1, 0, 1], "zero")])
def test_g2_special_cases_match_the_plain_loop_and_the_oracle(bits, branch):
    """A G2 point Q of order 13 (13 divides the twist's cofactor): 0b1111
    reaches acc = 14Q = Q before its last addition, 0b1101 reaches 12Q =
    -Q. Held to the port's plain loop (the JAX scan's G2 body compiles for
    minutes on the CPU; the plain loop is held to it in
    tests/test_torch_curve.py) and, as points, to the oracle's kQ."""
    q13 = O.point_of_order(2, 13, 2220)
    affs = [q13, _subgroup(random.Random(2221), True, 1)[0]]
    qx, qy = _rows(affs)
    taken = []
    got = r_scalar_mul(True, qx, qy, bits, taken)
    assert taken[sum(bits) - 1] == branch
    plain = curve.scalar_mul_fixed(
        curve.FQ2_OPS, fq.limbs_from_numpy(qx, "cpu"),
        fq.limbs_from_numpy(qy, "cpu"), bits)
    _same_pt(got, plain)
    k = int("".join(map(str, bits)), 2)
    for i, aff in enumerate(affs):
        want = O.ec_mul(O.ec_from_affine(aff), k)
        row = {c: plain[c][i].numpy() for c in "xyz"}
        at_inf = bool(towers.fq2_is_zero(plain["z"][i]))
        assert at_inf == (want is None)
        if want is not None:
            zi = towers.fq2_to_oracle(row["z"]).inverse()
            assert towers.fq2_to_oracle(row["x"]) * zi * zi == \
                O.ec_to_affine(want)[0]
            assert towers.fq2_to_oracle(row["y"]) * zi * zi * zi == \
                O.ec_to_affine(want)[1]


def _batch(values):
    """Replayed values (one a row) as one uint64 array."""
    return np.array(values, dtype=np.uint64)


def test_g2_steps_match_jax_at_the_ladders_accumulators():
    """The replay's G2 doubling and mixed addition (tw_jac_double,
    tw_jac_add_mixed over Fq2) against the JAX package's double and
    add_mixed over FQ2_OPS, op by op as tests/test_torch_curve.py runs
    them (a jit of the G2 addition compiles for over a minute), limb for
    limb, at every
    accumulator the order-13 point's ladders over 0b1111 and 0b1101
    reach: doubled infinity (X and Y multiples of p), Q (the addition is
    the doubling the loop makes next), -Q (all-zero limbs) and generic
    points; the doubling also at the accumulators before it."""
    q13 = O.point_of_order(2, 13, 2220)
    qx, qy = _rows([q13])
    x, y = (tuple(list(map(int, c)) for c in v[0]) for v in (qx, qy))
    seen, taken = [], []
    for bits in ([1, 1, 1, 1], [1, 1, 0, 1]):
        r_scalar_mul_row(RFq2, x, y, bits, taken, seen)
    assert {"inf", "add", "double", "zero"} <= set(taken)
    adds = [acc for k, acc in seen if k == "add"]
    accs = [acc for _, acc in seen]

    def pt(accs):
        return {k: jnp.asarray(_batch([a[i] for a in accs]))
                for i, k in enumerate("xyz")}
    def j_double(p):
        return jcurve.double(jcurve.FQ2_OPS, p)

    def j_add(p, a, b):
        return jcurve.add_mixed(jcurve.FQ2_OPS, p, a, b)
    doubled = [r_double(RFq2, a) for a in accs]
    _same_pt([_batch([d[i] for d in doubled]) for i in range(3)],
             {k: np.asarray(v) for k, v in j_double(pt(accs)).items()})
    added = [r_add_mixed(RFq2, a, x, y, []) or r_double(RFq2, a)
             for a in adds]
    n = len(adds)
    want = j_add(pt(adds), jnp.asarray(np.repeat(qx, n, axis=0)),
                 jnp.asarray(np.repeat(qy, n, axis=0)))
    _same_pt([_batch([a[i] for a in added]) for i in range(3)],
             {k: np.asarray(v) for k, v in want.items()})


def test_g2_replay_matches_the_plain_loop_on_a_short_scalar():
    """16 bits on two subgroup points and one off the subgroup."""
    rng = random.Random(2230)
    affs = _subgroup(rng, True, 2) + O.off_subgroup_points(
        2, 1, 2231)
    qx, qy = _rows(affs)
    bits = SHORT_BITS
    got = r_scalar_mul(True, qx, qy, bits)
    _same_pt(got, curve.scalar_mul_fixed(
        curve.FQ2_OPS, fq.limbs_from_numpy(qx, "cpu"),
        fq.limbs_from_numpy(qy, "cpu"), bits))


def test_doubling_infinity_leaves_multiples_of_p():
    """double((0, 0, 0)) gives Z == 0 but X and Y with non-zero limbs that
    are multiples of p: a test of infinity has to be mod p (the kernel's
    tw_is_zero, the plain loop's fq.is_zero), never on raw limbs."""
    zero = torch.zeros(1, L, dtype=torch.int64)
    pt = curve.double(curve.FQ_OPS, curve.point(zero, zero, zero))
    assert not pt["z"].any()
    for c in ("x", "y"):
        v = _int(pt[c][0].tolist())
        assert v != 0 and v % O.P == 0
        assert bool(fq.is_zero(pt[c])[0])
    x, y, z = r_double(RFq, (RFq.zero(), RFq.zero(), RFq.zero()))
    assert (x, y, z) == (pt["x"][0].tolist(), pt["y"][0].tolist(), [0] * L)
    assert RFq.is_zero(x) and RFq.is_zero(y) and any(x) and any(y)


# ---------------------------------------------------------------------------
# the dispatcher and the wrapper on CPU tensors


def test_dispatcher_on_cpu_tensors_runs_the_plain_loop(monkeypatch):
    log = []
    real = curve.scalar_mul_fixed_plain
    monkeypatch.setattr(curve, "scalar_mul_fixed_plain",
                        lambda *a: log.append("plain") or real(*a))
    monkeypatch.setattr(cuda_tower, "scalar_mul",
                        lambda *a, **k: log.append("wrapper"))
    qx, qy = _rows(_subgroup(random.Random(2240), False, 2))
    out = curve.scalar_mul_fixed(curve.FQ_OPS, fq.limbs_from_numpy(qx, "cpu"),
                                 fq.limbs_from_numpy(qy, "cpu"), [1, 0, 1])
    assert log == ["plain"]
    _same_pt(r_scalar_mul(False, qx, qy, [1, 0, 1]), out)


def test_an_empty_bit_list_gives_infinity():
    qx, qy = _rows(_subgroup(random.Random(2241), True, 2))
    out = curve.scalar_mul_fixed(curve.FQ2_OPS, fq.limbs_from_numpy(qx, "cpu"),
                                 fq.limbs_from_numpy(qy, "cpu"), [])
    assert all(not out[k].any() for k in "xyz")
    assert out["z"].shape == (2, 2, L)


@pytest.mark.parametrize("g2", [False, True])
def test_wrapper_refuses_what_the_kernel_does_not_take(g2):
    """CPU tensors (the dispatcher runs the plain loop there), int32
    limbs, trailing dims of neither group or of G1 where G2 is named, more
    bits than the kernel's words hold."""
    tail = (2, L) if g2 else (L,)
    q = torch.zeros((3,) + tail, dtype=torch.int64)
    with pytest.raises(ValueError, match="not one CUDA device"):
        cuda_tower.scalar_mul(q, q, R_BITS, g2=g2)
    with pytest.raises(TypeError):
        cuda_tower.scalar_mul(q.to(torch.int32), q, R_BITS, g2=g2)
    with pytest.raises(ValueError, match="trailing dims"):
        cuda_tower.scalar_mul(q[..., :-1], q, R_BITS, g2=g2)
    if g2:  # (3, 3, 15) holds G1 rows, not twist points
        wrong = torch.zeros((3, 3, L), dtype=torch.int64)
        with pytest.raises(ValueError, match="trailing dims"):
            cuda_tower.scalar_mul(wrong, wrong, R_BITS, g2=g2)
        with pytest.raises(ValueError, match="trailing dims"):
            cuda_tower.scalar_mul(q[:, 0], q[:, 0], R_BITS, g2=g2)
    with pytest.raises(ValueError, match="bits"):
        cuda_tower.scalar_mul(q, q, [1] * (cuda_tower.SCALAR_MUL_MAX_BITS + 1),
                              g2=g2)


@pytest.mark.parametrize("bits", [[1], [0, 1], [1, 0, 0], R_BITS,
                                  [1] * 33, [0] * 31 + [1]])
def test_packed_words_hold_every_bit(bits):
    """The kernel reads bit t at bit t % 32 of word t // 32, the first one
    included (the JAX scan doubles infinity at the first bit too)."""
    words = list(cuda_tower._scalar_words(tuple(bits)))
    assert len(words) == max(1, -(-len(bits) // 32))
    assert [(words[t >> 5] >> (t & 31)) & 1 for t in range(len(bits))] \
        == bits
    src = (CSRC / "scalar_mul.cu").read_text()
    max_words = int(re.search(r"#define SM_MAX_WORDS (\d+)", src).group(1))
    assert max_words * 32 == cuda_tower.SCALAR_MUL_MAX_BITS
    assert "scalar_mul" in cuda_tower.KERNELS


# ---------------------------------------------------------------------------
# products and the dependent path


def _count_plain(monkeypatch):
    counted = [0]
    real = cuda_fq.mont_mul

    def count(a, b):
        counted[0] += torch.broadcast_shapes(a.shape, b.shape)[:-1].numel()
        return real(a, b)
    monkeypatch.setattr(cuda_fq, "mont_mul", count)
    return counted


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_montgomery_product_counts(monkeypatch, group):
    """MONTS against the plain version (a doubling; the plain addition,
    which makes every branch, is the generic branch and a doubling), and
    the replay's branch by branch: the infinity test alone, the zero tests
    of H and R (p == -Q), and the generic branch."""
    g2 = group == "g2"
    F, RF = (curve.FQ2_OPS, RFq2) if g2 else (curve.FQ_OPS, RFq)
    m = {k: cuda_tower.MONTS[f"{group}_{k}"]
         for k in ("double", "inf", "hr", "add_mixed")}
    counted = _count_plain(monkeypatch)
    aff = _subgroup(random.Random(2250), g2, 2)
    qx, qy = (fq.limbs_from_numpy(v, "cpu") for v in _rows(aff))
    pt = curve.point(qx[:1], qy[:1], qx[1:])
    curve.double(F, pt)
    assert counted[0] == m["double"]
    counted[0] = 0
    curve.add_mixed(F, pt, qx[:1], qy[:1])
    assert counted[0] == m["add_mixed"] + m["double"]
    x, y = _rows(aff)
    row = [(tuple(list(map(int, c)) for c in v) if g2 else list(map(int, v)))
           for v in (x[0], y[0], x[1])]
    neg_y = r_double(RF, (row[0], row[1], RF.one()))  # 2Q: any point
    for p, want in (((RF.zero(), RF.zero(), RF.zero()), "inf"),
                    ((row[0], row[1], RF.one()), "hr"),
                    (neg_y, "add_mixed")):
        PRODUCTS[0] = 0
        r_add_mixed(RF, p, row[0], row[1], [])
        assert PRODUCTS[0] == m[want], want
    PRODUCTS[0] = 0
    r_double(RF, neg_y)
    assert PRODUCTS[0] == m["double"]


def test_the_smokes_product_count_is_the_replays():
    """chip_smoke._scalar_mul_products (the bound's product count, from the
    bits and the point's order alone) equals the products the replay
    makes, on subgroup rows (order r), a row off it (a multiple of r),
    and points of order 3 and 13 through every special branch."""
    cs = _smoke()
    cases = [(False, _subgroup(random.Random(2260), False, 1)[0], R_BITS,
              O.R),
             (False, O.off_subgroup_points(1, 1, 2261)[0], R_BITS, None),
             (False, O.point_of_order(1, 3, 2210),
              [1, 1, 0, 1, 0, 1, 1, 0, 1], 3),
             (True, O.point_of_order(2, 13, 2220),
              [1, 1, 1, 1, 0, 1, 1, 0, 1],
              13),
             (True, _subgroup(random.Random(2262), True, 1)[0],
              SHORT_BITS, O.R)]
    for g2, aff, bits, order in cases:
        qx, qy = _rows([aff])
        PRODUCTS[0] = 0
        r_scalar_mul(g2, qx, qy, bits)
        assert PRODUCTS[0] == cs._scalar_mul_products(
            "g2" if g2 else "g1", bits, order)


def test_cofactors():
    """#E(Fp) = G1_COFACTOR r and #E'(Fp2) = G2_COFACTOR r: a curve point
    times both is infinity; 3 and 13 divide them."""
    pt = O.ec_from_affine(O.off_subgroup_points(1, 1, 2270)[0])
    assert O.ec_mul(pt, O.G1_COFACTOR * O.R) is None
    pt = O.ec_from_affine(O.off_subgroup_points(2, 1, 2271)[0])
    assert O.ec_mul(pt, O.G2_COFACTOR * O.R) is None
    assert O.G1_COFACTOR % 3 == 0 and O.G2_COFACTOR % 13 == 0


def _depth(fn, *args):
    return _smoke()._chain_depth(fn, *args)


def test_chain_depth_of_the_curve_steps():
    """By hand, on G1 from inputs of depth 0: the doubling's Y3 is 6 deep
    (C = Y^4 2, the compress of C in t2 3 so D 3, the compress of 2D in X3
    4, the compress of X3 in D - X3 5, the product by E 6); the mixed
    addition's generic branch 7 (Z^2 1, Z^3 2, S2 = qy Z^3 3, R 3 (S2, and
    Y's compress 1), H 2, H^2 3, H^3 4 and V = X H^2 4, X3 5 through the
    compresses of H^3 and 2V, the compress of X3 6, R (V - X3) 7). The
    selects over the branches count their conditions and both sides; the
    conditions, zero tests of Z, H and R, are one product past them (1, 3,
    4), under the generic branch. Over G2 a product is 2 deep (its
    compresses), a doubling 8 and an addition 12."""
    F, F2 = curve.FQ_OPS, curve.FQ2_OPS

    def double(F):
        return lambda x, y, z: curve.double(F, curve.point(x, y, z))

    def add(F):
        return lambda x, y, z, a, b: curve.add_mixed(
            F, curve.point(x, y, z), a, b)

    def tests(x, y, z, a, b):
        Z2 = fq.mont_mul(z, z)
        H = fq.sub(fq.mont_mul(a, Z2), x)
        R = fq.sub(fq.mont_mul(b, fq.mont_mul(Z2, z)), y)
        return {"z": fq.is_zero(z), "h": fq.is_zero(H), "r": fq.is_zero(R)}

    one, two = (1,), (1, 2)
    assert _depth(double(F), one, one, one) == 6
    assert _depth(add(F), one, one, one, one, one) == 7
    for name, depth in (("z", 1), ("h", 3), ("r", 4)):
        assert _depth(lambda *a: tests(*a)[name], one, one, one, one,
                      one) == depth
    assert _depth(double(F2), two, two, two) == 8
    assert _depth(add(F2), two, two, two, two, two) == 12


def test_chain_depth_counts_a_selects_condition():
    """A zero test is one product past the value it tests (its
    canonical form), over Fq and Fq2, and what &, ~ and indexing make of
    it keeps that depth; a select is as deep as the deepest of its
    condition and its sides, so a condition 3 deep over sides of depth 0
    and 1 gives 3."""
    one, two = (1,), (1, 2)
    assert _depth(fq.is_zero, one) == 1
    assert _depth(towers.fq2_is_zero, two) == 1
    assert _depth(lambda a, b: fq.is_zero(a) & ~fq.is_zero(
        fq.mont_mul(b, b))[..., None][..., 0], one, one) == 2

    def select(a, b, c):
        deep = fq.is_zero(fq.mont_mul(fq.mont_mul(c, c), c))
        return fq.select(deep, a, fq.mont_mul(b, b))
    assert _depth(select, one, one, one) == 3
    assert _depth(lambda a, b: fq.select(fq.is_zero(a), a, b), one,
                  one) == 1


def test_chain_depth_of_the_ladder():
    """The loop's path: after the first set bit (Q taken, the trace counts
    the generic side, 6 past qx and qy) each doubling and each addition
    adds 6 on G1; r's 255 doublings and 134 additions are 2,328 deep."""
    F = curve.FQ_OPS

    def ladder(bits):
        return lambda x, y: curve.scalar_mul_fixed_plain(F, x, y, bits)

    assert _depth(ladder([1]), (1,), (1,)) == 6
    assert _depth(ladder([1, 0]), (1,), (1,)) == 12
    assert _depth(ladder([1, 1]), (1,), (1,)) == 18
    assert _depth(ladder([1, 0, 1]), (1,), (1,)) == 24
    assert _depth(ladder(R_BITS), (1,), (1,)) == 2328
