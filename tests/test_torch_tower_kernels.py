"""The tower kernels (ops/cuda_tower.py: csrc/fq12_ladder.cu,
fq12_fold.cu, miller_loop.cu, g1_fold.cu over csrc/tower.cuh) on the CPU,
where no kernel can run:

- each caller on CPU tensors runs its plain version and launches nothing
  (every counter stays 0); the wrappers of ops/cuda_tower.py refuse CPU
  tensors and operands the kernels cannot take;
- the ladder's packed bit words in both modes, and tower.cuh's constants;
- a torch replay of each kernel's operation sequence, as the CUDA source
  orders it (tower.cuh's base-field operations, the block product's
  column sums, carries and two fold batches, the identity products taken
  and the skipped products left out exactly where the kernels have them),
  held against the JAX package limb for limb (tolerance 0);
- a product by ONE_MONT can change limbs, which is why the identity
  products stay;
- the dependent-product tracer the chip smoke's latency floors count
  with (``chip_smoke._chain_depth``), on chains derived by hand.

The kernels themselves are held against these plain versions on the card
in tests/test_torch_tower_cuda.py and ``python3 chip_smoke.py``.
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

from consensus_specs_tpu.ops import mesh_reduce as jred  # noqa: E402
from consensus_specs_tpu.ops import pairing as jpairing  # noqa: E402
from consensus_specs_tpu.ops import towers as jtw  # noqa: E402
from consensus_specs_tpu_torch.ops import (  # noqa: E402
    cuda_fq, cuda_tower, fq, mesh_reduce, mesh_rlc, pairing, towers)
from consensus_specs_tpu_torch.utils import bls12_381 as O  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

L = fq.NUM_LIMBS
CSRC = Path(cuda_tower.__file__).resolve().parent.parent / "csrc"


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


def _rand(rng, shape, bound=O.P):
    """Montgomery limbs of random values below ``bound`` (uint64)."""
    flat = [fq._int_to_limbs_np(rng.randrange(bound))
            for _ in range(int(np.prod(shape)))]
    return np.stack(flat).reshape(tuple(shape) + (L,))


def _t(x):
    return fq.limbs_from_numpy(x, "cpu")


def _same(got, want):
    got = got.numpy().astype(np.uint64) if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert np.array_equal(got, np.asarray(want).astype(np.uint64))


# ---------------------------------------------------------------------------
# the replay: tower.cuh's operations in torch, in the CUDA source's order

_MP1 = torch.from_numpy(fq._int_to_limbs_np(fq.MP + 1).astype(np.int64))
_ONE = torch.from_numpy(fq.ONE_MONT.astype(np.int64))
_B3 = torch.from_numpy(fq.to_mont_int(12).astype(np.int64))


def r_lin(a, b, sub):
    """mont.cuh fq_lin: a + (sub ? (MP + 1) + (MASK - b) : b), rippled limb
    by limb, the carry out of limb 14 dropped."""
    a, b = torch.broadcast_tensors(a, b)
    out = torch.empty_like(a)
    c = torch.zeros_like(a[..., 0])
    for k in range(L):
        rhs = _MP1[k] + (fq.MASK - b[..., k]) if sub else b[..., k]
        cur = a[..., k] + rhs + c
        out[..., k] = cur & fq.MASK
        c = cur >> fq.LIMB_BITS
    return out


def r_mul(a, b):
    """tw_mul: mont.cuh fq_mont_mul, whose integers mont_mul_plain gives."""
    return fq.mont_mul_plain(*torch.broadcast_tensors(a, b))


def r_add(a, b):
    return r_lin(a, b, False)


def r_sub(a, b):
    """tw_sub: b compressed (a product by ONE_MONT), then fq_lin's sub."""
    return r_lin(a, r_mul(b, _ONE.expand_as(b)), True)


def r_neg(a):
    return r_sub(torch.zeros_like(a), a)


def _c(x, i):
    return x[..., i, :]


def r_fq2_add(a, b):
    return torch.stack([r_add(_c(a, 0), _c(b, 0)), r_add(_c(a, 1), _c(b, 1))],
                       -2)


def r_fq2_sub(a, b):
    return torch.stack([r_sub(_c(a, 0), _c(b, 0)), r_sub(_c(a, 1), _c(b, 1))],
                       -2)


def r_fq2_neg(a):
    return torch.stack([r_neg(_c(a, 0)), r_neg(_c(a, 1))], -2)


def r_fq2_mul(a, b):
    t0 = r_mul(_c(a, 0), _c(b, 0))
    t1 = r_mul(_c(a, 1), _c(b, 1))
    t2 = r_mul(r_add(_c(a, 0), _c(a, 1)), r_add(_c(b, 0), _c(b, 1)))
    return torch.stack([r_sub(t0, t1), r_sub(t2, r_add(t0, t1))], -2)


def r_fq2_square(a):
    s = r_add(_c(a, 0), _c(a, 1))
    d = r_sub(_c(a, 0), _c(a, 1))
    c1 = r_mul(_c(a, 0), _c(a, 1))
    return torch.stack([r_mul(s, d), r_add(c1, c1)], -2)


def r_fq2_mul_scalar(a, s):
    return torch.stack([r_mul(_c(a, 0), s), r_mul(_c(a, 1), s)], -2)


def r_fq12_mul(a, b):
    """tw_fq12_mul: the 144 products, each column k's raw sum rippled into
    15 limbs, then the fold's batches (degrees 22..17, then 16..12), each
    batch reading the columns as they stood before it."""
    a, b = torch.broadcast_tensors(a, b)
    prod = r_mul(a[..., :, None, :], b[..., None, :, :])
    cols = []
    for k in range(23):
        s = sum(prod[..., i, k - i, :] for i in range(max(0, k - 11),
                                                      min(k, 11) + 1))
        col, c = torch.empty_like(s), torch.zeros_like(s[..., 0])
        for l in range(L):
            cur = s[..., l] + c
            col[..., l] = cur & fq.MASK
            c = cur >> fq.LIMB_BITS
        cols.append(col)
    for batch in (range(17, 23), range(12, 17)):
        new = list(cols)
        for k in batch:
            c2 = r_add(cols[k], cols[k])
            new[k - 6] = r_add(cols[k - 6], c2)
            new[k - 12] = r_sub(cols[k - 12], c2)
        cols = new
    return torch.stack(cols[:12], -2)


def r_one(batch=()):
    out = torch.zeros(tuple(batch) + (12, L), dtype=torch.int64)
    out[..., 0, :] = _ONE
    return out


def r_conjugate(f):
    """tw_fq12_conjugate: the odd coefficients negated."""
    return torch.stack([r_neg(f[..., k, :]) if k & 1 else f[..., k, :]
                        for k in range(12)], -2)


def r_ladder_runtime(fs, bits):
    """fq12_ladder_kernel, runtime bits: from one, at every bit a square
    and a product by the base or by one (the clear bit's product taken)."""
    acc = r_one(fs.shape[:-2])
    for t in range(bits.shape[1]):
        acc = r_fq12_mul(acc, acc)
        sel = torch.where(bits[:, t, None, None].bool(), fs, r_one())
        acc = r_fq12_mul(acc, sel)
    return acc


def r_ladder_static(f, exp_bits):
    """fq12_ladder_kernel, static bits: from f, a square at every bit after
    the top one (read from the packed words), a product at a set bit."""
    words = list(cuda_fq._chain_words(tuple(exp_bits)))
    acc = f
    for t in range(len(exp_bits) - 1):
        acc = r_fq12_mul(acc, acc)
        if (words[t >> 5] >> (t & 31)) & 1:
            acc = r_fq12_mul(acc, f)
    return acc


def r_fold(fs, from_one):
    """fq12_fold_kernel, sequential."""
    acc = r_one(fs.shape[1:-2]) if from_one else fs[0]
    for k in range(0 if from_one else 1, fs.shape[0]):
        acc = r_fq12_mul(acc, fs[k])
    return acc


def r_fold_level(acc):
    """cuda_tower.fq12_fold_level: fq12_fold_kernel from the first value
    with K = 2 over the level's pairs, the odd tail appended as it is."""
    m = acc.shape[0] // 2
    pairs = acc[:2 * m].reshape((m, 2) + acc.shape[1:]).transpose(0, 1)
    return torch.cat([r_fold(pairs, False), acc[2 * m:]])


def r_from_components(c00, c11w, c12w):
    """tw_fq12_from_components."""
    zero = torch.zeros_like(c00[..., 0, :])
    f = [torch.zeros_like(zero) for _ in range(12)]
    for comp, k in ((c00, 0), (c11w, 3), (c12w, 5)):
        f[k] = r_add(zero, r_sub(_c(comp, 0), _c(comp, 1)))
        f[k + 6] = r_add(zero, _c(comp, 1))
    return torch.stack(f, -2)


def r_dbl_step(T, xp, yp):
    """tw_dbl_step: the line from T, then ops/curve.py's double."""
    X, Y, Z = T
    X2 = r_fq2_square(X)
    A3 = r_fq2_add(r_fq2_add(X2, X2), X2)
    Y2 = r_fq2_square(Y)
    Z2 = r_fq2_square(Z)
    Z3 = r_fq2_mul(Z2, Z)
    YZ3 = r_fq2_mul(Y, Z3)
    YZ3 = r_fq2_add(YZ3, YZ3)
    xi = torch.stack([_ONE, _ONE]).expand_as(X)
    c1 = r_fq2_mul_scalar(r_fq2_neg(r_fq2_mul(YZ3, xi)), yp)
    cv2w = r_fq2_mul_scalar(r_fq2_mul(A3, Z2), xp)
    cvw = r_fq2_sub(r_fq2_add(Y2, Y2), r_fq2_mul(A3, X))
    line = r_from_components(c1, cvw, cv2w)
    A, B = r_fq2_square(X), r_fq2_square(Y)
    C = r_fq2_square(B)
    t = r_fq2_sub(r_fq2_sub(r_fq2_square(r_fq2_add(X, B)), A), C)
    D = r_fq2_add(t, t)
    E = r_fq2_add(r_fq2_add(A, A), A)
    X3 = r_fq2_sub(r_fq2_square(E), r_fq2_add(D, D))
    u = r_fq2_add(C, C)
    u = r_fq2_add(u, u)
    u = r_fq2_add(u, u)
    Y3 = r_fq2_sub(r_fq2_mul(E, r_fq2_sub(D, X3)), u)
    t = r_fq2_mul(Y, Z)
    return line, (X3, Y3, r_fq2_add(t, t))


def r_add_step(T, qx, qy, xp, yp):
    """tw_add_step: the line, then the mixed addition's generic path."""
    X, Y, Z = T
    Z2 = r_fq2_square(Z)
    Z3 = r_fq2_mul(Z2, Z)
    H = r_fq2_sub(r_fq2_mul(qx, Z2), X)
    Rr = r_fq2_sub(r_fq2_mul(qy, Z3), Y)
    HZ = r_fq2_mul(H, Z)
    xi = torch.stack([_ONE, _ONE]).expand_as(X)
    c1 = r_fq2_mul_scalar(r_fq2_neg(r_fq2_mul(HZ, xi)), yp)
    cv2w = r_fq2_mul_scalar(Rr, xp)
    cvw = r_fq2_sub(r_fq2_mul(qy, HZ), r_fq2_mul(Rr, qx))
    line = r_from_components(c1, cvw, cv2w)
    H2 = r_fq2_square(H)
    H3 = r_fq2_mul(H2, H)
    V = r_fq2_mul(X, H2)
    X3 = r_fq2_sub(r_fq2_sub(r_fq2_square(Rr), H3), r_fq2_add(V, V))
    Y3 = r_fq2_sub(r_fq2_mul(Rr, r_fq2_sub(V, X3)), r_fq2_mul(Y, H3))
    return line, (X3, Y3, HZ)


def r_miller_iteration(f, T, qx, qy, xp, yp, bit):
    """One iteration of miller_loop_kernel: f^2, the doubling step, f *
    line, then the addition step and f * line2 on a set bit, f * one on a
    clear bit (the product taken)."""
    f = r_fq12_mul(f, f)
    line, T = r_dbl_step(T, xp, yp)
    f = r_fq12_mul(f, line)
    if bit:
        line, T = r_add_step(T, qx, qy, xp, yp)
        return r_fq12_mul(f, line), T
    return r_fq12_mul(f, r_one(f.shape[:-2])), T


def r_g1_add(p1, p2):
    """tw_g1_complete_add, in the CUDA source's order."""
    X1, Y1, Z1 = (p1[..., i, :] for i in range(3))
    X2, Y2, Z2 = (p2[..., i, :] for i in range(3))
    t0, t1, t2 = r_mul(X1, X2), r_mul(Y1, Y2), r_mul(Z1, Z2)
    t3 = r_sub(r_mul(r_add(X1, Y1), r_add(X2, Y2)), r_add(t0, t1))
    t4 = r_sub(r_mul(r_add(Y1, Z1), r_add(Y2, Z2)), r_add(t1, t2))
    X3 = r_mul(r_add(X1, Z1), r_add(X2, Z2))
    Y3 = r_sub(X3, r_add(t0, t2))
    X3 = r_add(t0, t0)
    t0 = r_add(X3, t0)
    t2 = r_mul(t2, _B3.expand_as(t2))
    Z3 = r_add(t1, t2)
    t1 = r_sub(t1, t2)
    Y3 = r_mul(Y3, _B3.expand_as(Y3))
    X3 = r_mul(t4, Y3)
    t2 = r_mul(t3, t1)
    X3 = r_sub(t2, X3)
    Y3 = r_mul(Y3, t0)
    t1 = r_mul(t1, Z3)
    Y3 = r_add(t1, Y3)
    t0 = r_mul(t0, t3)
    Z3 = r_add(r_mul(Z3, t4), t0)
    return torch.stack([X3, Y3, Z3], -2)


def r_g1_fold(points):
    """g1_fold_kernel: from (0 : 1 : 0), point after point."""
    acc = torch.zeros((3, L), dtype=torch.int64)
    acc[1] = _ONE
    for i in range(points.shape[0]):
        acc = r_g1_add(acc, points[i])
    return acc


# ---------------------------------------------------------------------------
# the replay against the JAX package, limb for limb
#
# The JAX functions whose loops the kernels replace are a lax.scan of
# towers.fq12_mul, which XLA compiles for 15-40 s on the CPU at each shape
# (and eagerly each Fq12 product costs 1-2 s of dispatch). So the Fq12
# references are the JAX package's own fq12_mul, jitted once at one
# element's shape, composed row by row as each JAX function's scan body
# and tree compose it (rlc_combine: square, then a product by
# select(bit, f, one); _pow_fixed: square, the product made and kept only
# at a set bit; mesh_rlc._local_fold: from one; pairing_product_is_one:
# from the first). The G1 fold and the Miller steps call the JAX
# functions themselves.

_JAX_FQ12_MUL = jax.jit(jtw.fq12_mul)
_J_ONE = np.asarray(jtw.fq12_one(())).astype(np.uint64)


def j_mul(a, b):
    return np.asarray(_JAX_FQ12_MUL(a, b)).astype(np.uint64)


def j_rlc_combine(fs, bits):
    """consensus_specs_tpu/ops/pairing.py rlc_combine, row by row."""
    accs = []
    for f, row in zip(fs, bits):
        acc = _J_ONE
        for bit in row:
            acc = j_mul(acc, acc)
            acc = j_mul(acc, f if bit else _J_ONE)
        accs.append(acc)
    while len(accs) > 1:
        m = len(accs) // 2
        accs = [j_mul(accs[2 * i], accs[2 * i + 1])
                for i in range(m)] + accs[2 * m:]
    return accs[0]


def j_pow_fixed(f, exp_bits):
    """consensus_specs_tpu/ops/pairing.py _pow_fixed on one element: the
    product by f made at every bit, kept at a set bit."""
    acc = f
    for bit in exp_bits[1:]:
        acc = j_mul(acc, acc)
        acc_mul = j_mul(acc, f)
        acc = acc_mul if bit else acc
    return acc


def j_fold(fs, from_one):
    acc = _J_ONE if from_one else fs[0]
    for f in (fs if from_one else fs[1:]):
        acc = j_mul(acc, f)
    return acc


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_rlc_combine_replay_matches_jax(n):
    """fq12_ladder (runtime bits, B = 8) then ceil(log2 n) pairwise levels
    (n = 3 and 5 carry an odd tail up) against the JAX package's
    rlc_combine; the port's rlc_combine (its wrappers on CPU tensors)
    too."""
    rng = random.Random(2100 + n)
    fs = _rand(rng, (n, 12), 1 << 382)
    bits = np.array([[rng.randrange(2) for _ in range(8)] for _ in range(n)],
                    dtype=bool)
    bits[0, 0] = bits[-1, -1] = False
    acc = r_ladder_runtime(_t(fs), torch.from_numpy(bits))
    levels = 0
    while acc.shape[0] > 1:
        acc = r_fold_level(acc)
        levels += 1
    assert levels == (n - 1).bit_length()
    want = j_rlc_combine(fs, bits)
    _same(acc[0], want)
    _same(pairing.rlc_combine(_t(fs), torch.from_numpy(bits)), want)


def test_pow_fixed_replay_matches_jax():
    """fq12_ladder (static bits: an 8-bit exponent with clear and set bits
    after the top one) against the JAX package's _pow_fixed."""
    rng = random.Random(2110)
    f = _rand(rng, (2, 12))
    exp_bits = [1, 0, 1, 1, 0, 0, 1, 0]
    want = np.stack([j_pow_fixed(row, exp_bits) for row in f])
    _same(r_ladder_static(_t(f), exp_bits), want)
    _same(pairing._pow_fixed(_t(f), exp_bits), want)


@pytest.mark.parametrize("k", [1, 3])
def test_fq12_fold_replay_matches_jax(k):
    """fq12_fold from one (one * f_0 taken) against the JAX package's
    mesh_rlc._local_fold, and from the first value against its
    pairing_product_is_one's list order."""
    rng = random.Random(2120 + k)
    fs = _rand(rng, (k, 12))
    want = j_fold(fs, True)
    _same(r_fold(_t(fs), True), want)
    _same(mesh_rlc._local_fold(_t(fs)), want)
    want = j_fold(fs, False)
    _same(r_fold(_t(fs), False), want)
    _same(pairing._fq12_product_plain(_t(fs)), want)


@pytest.mark.parametrize("k", [1, 3])
def test_g1_fold_replay_matches_jax(k):
    """g1_fold from infinity (inf + P_0 taken), a doubling in the shard,
    against the JAX package's mesh_reduce._local_fold."""
    rng = random.Random(2130 + k)
    pts = []
    for _ in range(k):
        x, y = O.ec_to_affine(O.ec_mul(O.G1_GEN, rng.randrange(1, O.R)))
        pts.append([fq.to_mont_int(x.n), fq.to_mont_int(y.n),
                    fq.to_mont_int(1)])
    if k > 1:
        pts[1] = pts[0]  # P + P: the complete addition's doubling case
    pts = np.array(pts, dtype=np.uint64)
    want = jred._local_fold(jnp.asarray(pts))
    _same(r_g1_fold(_t(pts)), want)
    _same(mesh_reduce._local_fold(_t(pts)), want)


def test_miller_iterations_replay_match_jax():
    """One iteration of miller_loop_kernel on a set and on a clear bit
    against the JAX package's _dbl_step, _add_step and fq12_mul composed
    as its scan body composes them (on the clear bit the product by one
    taken, the addition step's T selected away); then the conjugation."""
    rng = random.Random(2140)
    f = _rand(rng, (2, 12))
    T = [_rand(rng, (2, 2)) for _ in range(3)]
    qx, qy = _rand(rng, (2, 2)), _rand(rng, (2, 2))
    px, py = _rand(rng, (2,)), _rand(rng, (2,))
    jT = {"x": jnp.asarray(T[0]), "y": jnp.asarray(T[1]),
          "z": jnp.asarray(T[2])}
    line, jT = jpairing._dbl_step(jT, jnp.asarray(px), jnp.asarray(py))
    line2, jT_added = jpairing._add_step(jT, jnp.asarray(qx), jnp.asarray(qy),
                                         jnp.asarray(px), jnp.asarray(py))
    line, line2 = np.asarray(line), np.asarray(line2)
    jf = [j_mul(j_mul(row, row), line[i]) for i, row in enumerate(f)]
    for bit in (1, 0):
        got_f, got_T = r_miller_iteration(
            _t(f), tuple(_t(x) for x in T), _t(qx), _t(qy), _t(px), _t(py),
            bit)
        want_f = np.stack([j_mul(jf[i], line2[i] if bit else _J_ONE)
                           for i in range(2)])
        _same(got_f, want_f)
        for got, name in zip(got_T, "xyz"):
            _same(got, (jT_added if bit else jT)[name])
        _same(r_conjugate(got_f), jtw.fq12_conjugate(want_f))


def test_a_product_by_one_can_change_limbs():
    """Why the identity products stay: a Montgomery product by ONE_MONT
    keeps the value mod p but not always its limbs, and so does an Fq12
    product by one."""
    rng = random.Random(2150)
    x = _rand(rng, (8,), 1 << 401)
    y = fq.mont_mul_plain(_t(x), _ONE.expand(8, L))
    assert any(not np.array_equal(y[i].numpy(), x[i]) for i in range(8))
    assert all(fq.from_mont_limbs(y[i].numpy()) == fq.from_mont_limbs(x[i])
               for i in range(8))
    f = _t(_rand(rng, (1, 12), 1 << 382))
    g = towers.fq12_mul(towers.fq12_one((1,), "cpu"), f)
    assert not torch.equal(g, f)
    assert towers.fq12_to_oracle(g[0]) == towers.fq12_to_oracle(f[0])


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors, the bit words, the CUDA source's constants


def _recording(monkeypatch, module, name, log):
    real = getattr(module, name)

    def run(*args, **kwargs):
        log.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, run)


def test_wrappers_on_cpu_tensors_run_the_plain_versions(monkeypatch):
    """Each caller of a tower kernel on CPU tensors calls its plain version
    and no wrapper of ops/cuda_tower.py (the autouse fixture holds every
    counter at 0)."""
    log = []
    for module, name in ((pairing, "_rlc_ladder_plain"),
                         (pairing, "_fq12_tree_level_plain"),
                         (pairing, "_pow_fixed_plain"),
                         (mesh_rlc, "_local_fold_plain")):
        _recording(monkeypatch, module, name, log)
    for name in ("fq12_ladder", "fq12_pow", "fq12_fold", "fq12_fold_level",
                 "miller_loop", "g1_fold"):
        _recording(monkeypatch, cuda_tower, name, log)
    # the Miller loop's, the pairs' product's and the G1 fold's plain
    # versions are held to JAX above; here only that the callers reach them
    monkeypatch.setattr(pairing, "miller_loop_plain",
                        lambda *a: log.append("miller_loop_plain") or "ml")
    monkeypatch.setattr(pairing, "_fq12_product_plain",
                        lambda fs: log.append("_fq12_product_plain") or "f")
    monkeypatch.setattr(pairing, "final_exp_is_one", lambda f: f == "f")
    monkeypatch.setattr(mesh_reduce, "_local_fold_plain",
                        lambda p: log.append("g1_fold_plain") or "g1")
    monkeypatch.setattr(pairing, "miller_loop",
                        lambda *a: (log.append("miller_loop") or
                                    torch.zeros(2, 12, L, dtype=torch.int64)))
    rng = random.Random(2160)
    fs = _t(_rand(rng, (3, 12)))
    bits = torch.tensor([[1, 0], [0, 1], [1, 1]], dtype=torch.bool)
    pairing.rlc_combine(fs, bits)
    pairing._pow_fixed(fs, [1, 1])
    mesh_rlc._local_fold(fs)
    z = torch.zeros(2, L, dtype=torch.int64)
    assert pairing.pairing_product_is_one([(z[0], z[1], z[:2], z[:2])] * 2)
    monkeypatch.undo()
    zero2 = torch.zeros(2, 2, L, dtype=torch.int64)
    monkeypatch.setattr(pairing, "miller_loop_plain",
                        lambda *a: log.append("miller_loop_plain") or "ml")
    monkeypatch.setattr(mesh_reduce, "_local_fold_plain",
                        lambda p: log.append("g1_fold_plain") or "g1")
    assert pairing.miller_loop(zero2, zero2, z, z) == "ml"
    assert mesh_reduce._local_fold(torch.zeros(2, 3, L,
                                               dtype=torch.int64)) == "g1"
    assert log == ["_rlc_ladder_plain", "_fq12_tree_level_plain",
                   "_fq12_tree_level_plain", "_pow_fixed_plain",
                   "_local_fold_plain", "miller_loop", "_fq12_product_plain",
                   "miller_loop_plain", "g1_fold_plain"]


def test_wrappers_refuse_cpu_tensors():
    """The wrappers of ops/cuda_tower.py take CUDA tensors only: on CPU
    tensors each raises rather than running anything (the callers run the
    plain versions there)."""
    rng = random.Random(2170)
    fs = _t(_rand(rng, (3, 12)))
    z = torch.zeros(2, L, dtype=torch.int64)
    z2 = torch.zeros(2, 2, L, dtype=torch.int64)
    for call in (lambda: cuda_tower.fq12_ladder(
                     fs, torch.ones(3, 2, dtype=torch.bool)),
                 lambda: cuda_tower.fq12_pow(fs, [1, 0, 1]),
                 lambda: cuda_tower.fq12_fold(fs, from_one=True),
                 lambda: cuda_tower.fq12_fold(fs, from_one=False),
                 lambda: cuda_tower.fq12_fold_level(fs),
                 lambda: cuda_tower.miller_loop(z2, z2, z, z,
                                                pairing._ATE_BITS),
                 lambda: cuda_tower.g1_fold(torch.zeros(2, 3, L,
                                                        dtype=torch.int64))):
        with pytest.raises(ValueError, match="not one CUDA device"):
            call()


@pytest.mark.parametrize("bad,error", [
    (lambda: torch.zeros(2, 12, L, dtype=torch.int32), TypeError),
    (lambda: torch.zeros(2, 11, L, dtype=torch.int64), ValueError),
    (lambda: torch.zeros(2, 12, L, dtype=torch.int64, device="meta"),
     ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, error):
    with pytest.raises(error):
        cuda_tower.fq12_pow(bad(), [1, 0])
    with pytest.raises(error):
        cuda_tower.fq12_fold_level(bad())
    with pytest.raises(ValueError):
        cuda_tower.fq12_pow(torch.zeros(1, 12, L, dtype=torch.int64),
                            [1] * (cuda_tower.POW_MAX_BITS + 2))


@pytest.mark.parametrize("b", [1, 8, 31, 32, 33, 128])
def test_runtime_words_pack_each_row_first_bit_first(b):
    """Runtime bits: row n's bit t at bit t % 32 of word t // 32, the order
    of _chain_words (which also drops a top bit)."""
    rng = np.random.default_rng(b)
    bits = rng.random((3, b)) < 0.5
    words = cuda_tower.runtime_words(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    assert words.shape == (3, max(1, -(-b // 32)))
    for row, w in zip(bits, words.tolist()):
        want = list(cuda_fq._chain_words((1,) + tuple(int(x) for x in row)))
        assert [x & 0xFFFFFFFF for x in w] == want


def test_static_words_hold_every_exponent_of_the_path():
    """Static bits: the x-chains' and the 4,314-bit final exponent's tails
    fit the kernel's TW_MAX_WORDS words, and unpack to the bits."""
    for exp_bits in (pairing._ABS_X_BITS, pairing._ABS_X_PLUS_1_BITS,
                     [1] + pairing._FINAL_EXP_BITS):
        tail = exp_bits[1:]
        assert len(tail) <= cuda_tower.POW_MAX_BITS
        words = list(cuda_fq._chain_words(tuple(exp_bits)))
        assert [(words[t >> 5] >> (t & 31)) & 1
                for t in range(len(tail))] == tail
    assert len(pairing._FINAL_EXP_BITS) == 4313
    assert (sum(pairing._ABS_X_BITS[1:]), sum(pairing._ABS_X_PLUS_1_BITS[1:])
            ) == (5, 6)


def _cuda_array(name):
    src = (CSRC / "tower.cuh").read_text()
    body = re.search(name + r"\[FQ_LIMBS\] = \{([^}]*)\}", src).group(1)
    return [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", body)]


def test_tower_header_constants():
    """tower.cuh's ONE_MONT and 3b, and its static-exponent capacity."""
    assert _cuda_array("TW_ONE") == [int(x) for x in fq.ONE_MONT]
    assert _cuda_array("TW_B3") == [int(x) for x in fq.to_mont_int(12)]
    words = int(re.search(r"#define TW_MAX_WORDS (\d+)",
                          (CSRC / "tower.cuh").read_text()).group(1))
    assert words * 32 == cuda_tower.POW_MAX_BITS
    assert "fq12_ladder" in cuda_tower.KERNELS
    from consensus_specs_tpu_torch.ops import cuda_build

    assert set(cuda_tower.KERNELS) <= set(cuda_build.KERNELS)
    assert "tower.cuh" in cuda_build._HEADERS


def test_ate_words_are_the_loop_bits():
    words, n_bits = cuda_tower._ate_words(tuple(pairing._ATE_BITS))
    assert n_bits == len(pairing._ATE_BITS) == 63
    assert [(words[t >> 5] >> (t & 31)) & 1 for t in range(n_bits)] \
        == pairing._ATE_BITS
    assert sum(pairing._ATE_BITS) == 5



def test_montgomery_product_counts_of_the_steps(monkeypatch):
    """cuda_tower.MONTS (the smoke's operation counts) equal the products
    the plain versions make, counted on one element each."""
    from consensus_specs_tpu_torch.ops.curve import point

    counted = [0]
    real = cuda_fq.mont_mul

    def count(a, b):
        counted[0] += torch.broadcast_shapes(a.shape, b.shape)[:-1].numel()
        return real(a, b)
    monkeypatch.setattr(cuda_fq, "mont_mul", count)
    rng = random.Random(2180)
    f = _t(_rand(rng, (12,)))
    T = point(*(_t(_rand(rng, (2,))) for _ in range(3)))
    q, p = _t(_rand(rng, (2, 2))), _t(_rand(rng, (2,)))
    pt = _t(_rand(rng, (3,)))
    for name, call in (
            ("fq12_mul", lambda: towers.fq12_mul(f, f)),
            ("dbl_step", lambda: pairing._dbl_step(T, p[0], p[1])),
            ("add_step", lambda: pairing._add_step(T, q[0], q[1], p[0], p[1])),
            ("conjugate", lambda: towers.fq12_conjugate(f)),
            ("g1_add", lambda: mesh_reduce.g1_complete_add(pt, pt))):
        counted[0] = 0
        call()
        assert counted[0] == cuda_tower.MONTS[name], name


# ---------------------------------------------------------------------------
# the chip smoke's dependent-product tracer


def _depth(fn, *args):
    import chip_smoke

    return chip_smoke._chain_depth(fn, *args)


def test_chain_depth_of_base_field_chains():
    """Chains whose depth is plain by hand: n products in a row are n deep;
    fq.add adds none; fq.sub compresses its subtrahend (one product) and
    not its minuend; a product by a constant counts one."""
    def chain(a, n):
        for _ in range(n):
            a = fq.mont_mul(a, a)
        return a

    one = _ONE.expand(1, L)
    for n in (0, 1, 5):
        assert _depth(lambda a: chain(a, n), (1,)) == n
    assert _depth(fq.add, (1,), (1,)) == 0
    assert _depth(fq.sub, (1,), (1,)) == 1
    assert _depth(lambda a, b: fq.sub(chain(a, 3), b), (1,), (1,)) == 3
    assert _depth(lambda a, b: fq.sub(a, chain(b, 3)), (1,), (1,)) == 4
    assert _depth(lambda a: fq.mont_mul(a, one), (1,)) == 1


def test_chain_depth_of_the_tower_steps():
    """An Fq12 product is two products deep: the 144 products, then the
    compress of a fold batch's subtrahend (the second batch reads the
    first's sums, not its compress). A G1 complete addition carries 5 on
    its accumulator: X3 = t3 t1 - t4 (3b ((X1 + Z1)(X2 + Z2) - (t0 + t2))),
    whose subtrahend passes t0 = X1 X2, the compress of t0 + t2, the
    product by 3b, the product by t4 and its own compress; a fold of K
    points from
    infinity is 5K deep. The Miller loop's longest path runs through the
    doubling steps' T chain into the lines, deeper than its 189 Fq12
    products on f alone (2 x 189 = 378)."""
    assert _depth(towers.fq12_mul, (1, 12), (1, 12)) == 2
    assert _depth(lambda a, b: towers.fq12_mul(towers.fq12_mul(a, b), b),
                  (1, 12), (1, 12)) == 4
    for k in (1, 2, 4):
        assert _depth(mesh_reduce._local_fold_plain, (k, 3)) == 5 * k
    depth = _depth(pairing.miller_loop_plain, (1, 2), (1, 2), (1,), (1,))
    assert depth > 2 * 3 * len(pairing._ATE_BITS)
    assert depth == 537

