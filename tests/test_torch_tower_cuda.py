"""The tower kernels (ops/cuda_tower.py) on the card against their plain
versions, raw limbs equal (max |err| 0): the Fq12 ladder in both modes
(runtime bits at 1, 3 and 64 rows; the x-chains and the 4,314-bit final
exponent), the Fq12 fold (sequential from one and from the first value,
and a pairwise tree level with an odd count), the Miller loop at 1, 3 and 64
rows, the G1 fold on a 512-point shard holding the point at infinity
and a doubling, and the scalar multiplication on G1 and G2 (r's bits and
a short scalar at 1, 64 and 129 rows in and off the subgroup, points of
order 3 and 13 through the mixed addition's special branches, an empty
bit list); each wrapper's launches counted one a call; a card that is
not the current device, where there is one.

Marked ``cuda``: they skip where no CUDA device is present, and run on a
GPU machine with

    python -m pytest tests/test_torch_tower_cuda.py -m cuda -q

(``python3 chip_smoke.py`` runs the kernels on the verify path's tower
route and holds them to the same plain versions.)
"""
import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu_torch.ops import (cuda_tower, curve, fq,
                                           mesh_reduce, mesh_rlc, pairing,
                                           towers)
from consensus_specs_tpu_torch.utils import bls12_381 as O

one_thread()

pytestmark = pytest.mark.cuda

L = fq.NUM_LIMBS
# a 16-bit scalar for the scalar-multiplication kernel beside r's bits
SHORT_BITS = [int(b) for b in bin(0xB5A3)[2:]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _loose(rng, shape, bits=382):
    limbs = rng.integers(0, 1 << 28, size=shape + (L,), dtype=np.int64)
    full, rest = divmod(bits, 28)
    limbs[..., full] &= (1 << rest) - 1
    limbs[..., full + 1:] = 0
    return torch.from_numpy(limbs)


def _counted(name, fn, times=1):
    """fn()'s result, asserting it launched kernel ``name`` ``times`` times
    and no other tower kernel."""
    before = cuda_tower.launches()
    out = fn()
    torch.cuda.synchronize()
    after = cuda_tower.launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: times * (k == name) for k in after}
    return out


def _same(got, want):
    assert got.shape == want.shape
    assert int((got.cpu() - want.cpu()).abs().max()) == 0


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_ladder_runtime_bits(dev, rows):
    rng = np.random.default_rng(rows)
    fs = _loose(rng, (rows, 12))
    bits = torch.from_numpy(rng.random((rows, 128)) < 0.5)
    bits[0, :3] = True
    bits[-1, -3:] = False
    got = _counted("fq12_ladder",
                   lambda: cuda_tower.fq12_ladder(fs.to(dev), bits.to(dev)))
    _same(got, pairing._rlc_ladder_plain(fs.to(dev), bits.to(dev)))


@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("chain", ["x", "x_plus_1"])
def test_ladder_static_bits(dev, rows, chain):
    exp_bits = (pairing._ABS_X_BITS if chain == "x"
                else pairing._ABS_X_PLUS_1_BITS)
    f = _loose(np.random.default_rng(100 + rows), (rows, 12)).to(dev)
    got = _counted("fq12_ladder", lambda: cuda_tower.fq12_pow(f, exp_bits))
    _same(got, pairing._pow_fixed_plain(f, exp_bits))


def test_ladder_the_whole_final_exponent(dev):
    """final_exp_is_one_full's 4,314-bit exponent (4,313 squares, every
    word of the static bits used) on one row."""
    exp_bits = [1] + pairing._FINAL_EXP_BITS
    f = _loose(np.random.default_rng(7), (1, 12)).to(dev)
    got = _counted("fq12_ladder", lambda: cuda_tower.fq12_pow(f, exp_bits))
    _same(got, pairing._pow_fixed_plain(f, exp_bits))


@pytest.mark.parametrize("k,m", [(1, 1), (3, 1), (2, 64), (5, 3)])
def test_fold_sequential(dev, k, m):
    fs = _loose(np.random.default_rng(10 * k + m), (k, m, 12)).to(dev)
    got = _counted("fq12_fold", lambda: cuda_tower.fq12_fold(fs, True))
    _same(got, mesh_rlc._local_fold_plain(fs))
    got = _counted("fq12_fold", lambda: cuda_tower.fq12_fold(fs, False))
    _same(got, pairing._fq12_product_plain(fs))


def test_fold_of_an_empty_shard_from_one(dev):
    """A slot with no chunk product folds to one, as the plain loop does."""
    fs = torch.zeros((0, 12, L), dtype=torch.int64, device=dev)
    got = _counted("fq12_fold", lambda: cuda_tower.fq12_fold(fs, True))
    _same(got, mesh_rlc._local_fold_plain(fs))


@pytest.mark.parametrize("n", [1, 3, 63, 64])
def test_fold_level(dev, n):
    """A level is one launch of the fold kernel over the pairs (none for a
    lone value, which is carried up as it is)."""
    acc = _loose(np.random.default_rng(200 + n), (n, 12)).to(dev)
    got = _counted("fq12_fold", lambda: cuda_tower.fq12_fold_level(acc),
                   times=int(n > 1))
    _same(got, pairing._fq12_tree_level_plain(acc))


def _pairs(rows, seed):
    """(qx, qy, px, py) Montgomery limbs of rows of k P, m Q."""
    rng = np.random.default_rng(seed)
    qx, qy, px, py = [], [], [], []
    for _ in range(rows):
        k, m = (int(x) for x in rng.integers(2, 1 << 60, size=2))
        x, y = O.ec_to_affine(O.ec_mul(O.G1_GEN, k))
        px.append(fq.to_mont_int(x.n))
        py.append(fq.to_mont_int(y.n))
        x, y = O.ec_to_affine(O.ec_mul(O.G2_GEN, m))
        qx.append(np.stack([fq.to_mont_int(x.c0), fq.to_mont_int(x.c1)]))
        qy.append(np.stack([fq.to_mont_int(y.c0), fq.to_mont_int(y.c1)]))
    return [fq.limbs_from_numpy(np.stack(v), "cpu")
            for v in (qx, qy, px, py)]


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_miller_loop(dev, rows):
    args = [a.to(dev) for a in _pairs(rows, rows)]
    got = _counted("miller_loop", lambda: cuda_tower.miller_loop(
        *args, pairing._ATE_BITS))
    _same(got, pairing.miller_loop_plain(*args))


def test_g1_fold_on_a_512_point_shard(dev):
    """A slot's shard of P2 (2,048 keys on 4 slots): 512 points, the first
    two equal (inf + P, then P + P: the complete addition's doubling) and
    one the point at infinity."""
    rng = np.random.default_rng(512)
    pts = np.zeros((512, 3, L), dtype=np.uint64)
    for i in range(512):
        x, y = O.ec_to_affine(O.ec_mul(O.G1_GEN,
                                       int(rng.integers(1, 1 << 62))))
        pts[i] = [fq.to_mont_int(x.n), fq.to_mont_int(y.n), fq.to_mont_int(1)]
    pts[1] = pts[0]  # inf + P, then P + P: a doubling
    pts[7] = mesh_reduce.infinity_point()
    t = fq.limbs_from_numpy(pts, dev)
    got = _counted("g1_fold", lambda: cuda_tower.g1_fold(t))
    _same(got, mesh_reduce._local_fold_plain(t))


def test_pairing_product_on_the_card(dev):
    """pairing_product_is_one: one Miller launch, one fold launch and the
    five x-chains' ladder launches; e(6P, Q) e(-P, 6Q) true, with 7P
    false."""
    def limbs(pt):
        x, y = O.ec_to_affine(pt)
        if isinstance(x, O.Fq2):
            return [fq.limbs_from_numpy(np.stack(
                [fq.to_mont_int(c.c0), fq.to_mont_int(c.c1)])[None], dev)
                for c in (x, y)]
        return [fq.limbs_from_numpy(fq.to_mont_int(c.n)[None], dev)
                for c in (x, y)]

    q1, q2 = limbs(O.G2_GEN), limbs(O.ec_mul(O.G2_GEN, 6))
    p2 = limbs(O.ec_neg(O.G1_GEN))
    before = cuda_tower.launches()
    got = [pairing.pairing_product_is_one(
        [(*limbs(O.ec_mul(O.G1_GEN, k)), *q1), (*p2, *q2)]).tolist()
        for k in (6, 7)]
    after = cuda_tower.launches()
    assert got == [[True], [False]]
    assert {k: after[k] - before[k] for k in after} == {
        "fq12_ladder": 10, "fq12_fold": 2, "miller_loop": 2, "g1_fold": 0,
        "scalar_mul": 0}


def _curve_rows(g2, rows, seed):
    """(qx, qy) Montgomery limbs of ``rows`` points of G1 or G2: k P of
    the subgroup, every fourth row off it."""
    rng = np.random.default_rng(seed)
    gen = O.G2_GEN if g2 else O.G1_GEN
    off = O.off_subgroup_points(2 if g2 else 1, -(-rows // 4), seed)
    affs = [off[i // 4] if i % 4 == 3 else
            O.ec_to_affine(O.ec_mul(gen, int(rng.integers(2, 1 << 60))))
            for i in range(rows)]
    return _limbs_of_points(affs)


def _limbs_of_points(affs):
    return [torch.from_numpy(v) for v in curve.affine_limbs(affs)]


def _same_pt(got, want):
    for k in "xyz":
        _same(got[k], want[k])


@pytest.mark.parametrize("rows", [1, 64, 129])
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("scalar", ["r", "short"])
def test_scalar_mul(dev, rows, group, scalar):
    """r * P (the subgroup check: infinity exactly on the subgroup rows)
    and a 16-bit scalar, through curve.scalar_mul_fixed (one launch)
    against the plain loop on the card."""
    g2 = group == "g2"
    F = curve.FQ2_OPS if g2 else curve.FQ_OPS
    bits = (curve.subgroup_check_bits() if scalar == "r"
            else SHORT_BITS)
    qx, qy = (x.to(dev) for x in _curve_rows(g2, rows, rows + 7 * g2))
    got = _counted("scalar_mul",
                   lambda: curve.scalar_mul_fixed(F, qx, qy, bits))
    _same_pt(got, curve.scalar_mul_fixed_plain(F, qx, qy, bits))
    if scalar == "r":
        is_zero = towers.fq2_is_zero if g2 else fq.is_zero
        assert is_zero(got["z"]).tolist() == [i % 4 != 3
                                              for i in range(rows)]


@pytest.mark.parametrize("group,k,bits", [
    (1, 3, [1, 0, 1]), (1, 3, [1, 1]),
    (2, 13, [1, 1, 1, 1]), (2, 13, [1, 1, 0, 1])])
def test_scalar_mul_special_branches(dev, group, k, bits):
    """A point of order 3 (G1) or 13 (G2): the bits meet acc = Q (the
    H == R == 0 branch, a doubling) or acc = -Q (H == 0: infinity) at
    their last addition; the point's negation and a subgroup point
    beside it."""
    q = O.point_of_order(group, k, 2300 + k)
    gen = O.G2_GEN if group == 2 else O.G1_GEN
    affs = [q, (q[0], -q[1]), O.ec_to_affine(O.ec_mul(gen, 5))]
    qx, qy = (x.to(dev) for x in _limbs_of_points(affs))
    F = curve.FQ2_OPS if group == 2 else curve.FQ_OPS
    got = _counted("scalar_mul",
                   lambda: cuda_tower.scalar_mul(qx, qy, bits,
                                                 g2=group == 2))
    _same_pt(got, curve.scalar_mul_fixed_plain(F, qx, qy, bits))


def test_scalar_mul_of_an_empty_bit_list(dev):
    """No bits: the point at infinity (0, 0, 0), as the plain loop gives
    it, without a launch."""
    qx, qy = (x.to(dev) for x in _curve_rows(True, 3, 1))
    got = _counted("scalar_mul", lambda: cuda_tower.scalar_mul(
        qx, qy, [], g2=True), times=0)
    _same_pt(got, curve.scalar_mul_fixed_plain(curve.FQ2_OPS, qx, qy, []))


def test_a_card_that_is_not_the_current_device(dev):
    """The wrappers make the operands' card current for the launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    f = _loose(np.random.default_rng(1), (3, 12)).to(other)
    got = _counted("fq12_ladder", lambda: cuda_tower.fq12_pow(
        f, pairing._ABS_X_BITS))
    assert got.device == other
    _same(got, pairing._pow_fixed_plain(f.cpu(), pairing._ABS_X_BITS))
    args = [a.to(other) for a in _pairs(2, 9)]
    got = _counted("miller_loop", lambda: cuda_tower.miller_loop(
        *args, pairing._ATE_BITS))
    _same(got, pairing.miller_loop_plain(*(a.cpu() for a in args)))
    qx, qy = _curve_rows(True, 2, 11)
    bits = SHORT_BITS
    got = _counted("scalar_mul", lambda: cuda_tower.scalar_mul(
        qx.to(other), qy.to(other), bits, g2=True))
    assert got["z"].device == other
    _same_pt(got, curve.scalar_mul_fixed_plain(curve.FQ2_OPS, qx, qy, bits))
