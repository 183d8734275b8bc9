"""The port's cross-slot butterflies (``ops/mesh_rlc.py``,
``ops/mesh_reduce.py``) on CPU meshes, held limb for limb against the
JAX package's own ``mesh_rlc.mesh_fq12_product`` and
``mesh_reduce.mesh_aggregate_g1`` on a mesh of the conftest's virtual CPU
devices, against the JAX package's ``towers.fq12_mul`` and
``mesh_reduce.g1_complete_add`` applied in the butterfly's order (each
slot folds its contiguous block from the identity, then
``local = op(local, recv)`` with recv from slot ``i ^ step``; slot 0's
value), with identity padding, and against the host oracle: the Fq12
product, the complete addition's cases and the aggregate pubkey's
bytes."""
import random

import jax
import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu.ops import mesh_reduce as jred
from consensus_specs_tpu.ops import mesh_rlc as jmesh_rlc
from consensus_specs_tpu.ops import towers as jtw
from consensus_specs_tpu.utils import jax_env
from consensus_specs_tpu_torch.ops import bls_backend as tbb
from consensus_specs_tpu_torch.ops import fq, mesh_reduce, mesh_rlc
from consensus_specs_tpu_torch.utils import bls
from consensus_specs_tpu_torch.utils import bls12_381 as O
from consensus_specs_tpu_torch.utils import torch_env

one_thread()

# the JAX package's ops, jitted once a shape (eager, each call re-dispatches
# hundreds of small ops)
_JAX_FQ12_MUL = jax.jit(jtw.fq12_mul)
_JAX_G1_ADD = jax.jit(jred.g1_complete_add)


def _jax_butterfly(rows, n_dev, filler, op):
    """The JAX package's schedule with its ops, one slot at a time."""
    rows = np.concatenate([rows, filler[:(-rows.shape[0]) % n_dev]])
    block = rows.shape[0] // n_dev
    locals_ = []
    for i in range(n_dev):
        acc = filler[0]
        for r in rows[i * block:(i + 1) * block]:
            acc = op(acc, r)
        locals_.append(acc)
    step = 1
    while step < n_dev:
        locals_ = [op(locals_[i], locals_[i ^ step]) for i in range(n_dev)]
        step *= 2
    return np.asarray(locals_[0]).astype(np.uint64)


def _rand_fq12(rng, n):
    return np.stack([
        np.stack([fq.to_mont_int(rng.randrange(O.P)) for _ in range(12)])
        for _ in range(n)])


@pytest.mark.parametrize("n_dev,n", [(2, 3), (4, 3), (4, 8)])
def test_fq12_butterfly_limbs_equal_jax_order(n_dev, n):
    """Identity padding (3 items on 4 slots), one and several items a
    slot; the limbs are the JAX ops' in the butterfly's order, and the
    value is the oracle's product."""
    rng = random.Random(17 + n_dev + n)
    fs = _rand_fq12(rng, n)
    mesh = torch_env.make_mesh(n_dev, "cpu")
    got = mesh_rlc.mesh_fq12_product(fs, mesh)
    want = _jax_butterfly(fs, n_dev, mesh_rlc.fq12_identity((n_dev,)),
                          _JAX_FQ12_MUL)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    prod = None
    for f in fs:
        x = tbb._flat_ints_to_oracle([fq.from_mont_limbs(c) for c in f])
        prod = x if prod is None else prod * x
    assert [fq.from_mont_limbs(got[j]) for j in range(12)] == \
        tbb._oracle_to_flat_ints(prod)


def test_fq12_identity_padding_reduces_to_one():
    one = mesh_rlc.fq12_identity()
    assert fq.from_mont_limbs(one[0]) == 1
    assert all(fq.from_mont_limbs(one[j]) == 0 for j in range(1, 12))
    got = mesh_rlc.mesh_fq12_product(mesh_rlc.fq12_identity((3,)),
                                     torch_env.make_mesh(4, "cpu"))
    assert [fq.from_mont_limbs(got[j]) for j in range(12)] == [1] + [0] * 11


def _proj(pt):
    out = np.zeros((3, fq.NUM_LIMBS), dtype=np.uint64)
    if pt is None:
        out[1] = fq.to_mont_int(1)
        return out
    x, y = pt
    out[0], out[1], out[2] = (fq.to_mont_int(x.n), fq.to_mont_int(y.n),
                              fq.to_mont_int(1))
    return out


def _affine(agg):
    x, y, z = (fq.from_mont_limbs(agg[i]) for i in range(3))
    if z == 0:
        return None
    zi = pow(z, -1, O.P)
    return (x * zi % O.P, y * zi % O.P)


def test_complete_add_matches_oracle_cases_and_jax_limbs():
    g = O.ec_to_affine(O.G1_GEN)
    two_g = O.ec_to_affine(O.ec_double(O.G1_GEN))
    cases = [(g, g), (g, two_g), (None, g), (g, None), (None, None),
             (g, (g[0], O.Fq((-g[1].n) % O.P)))]
    a = np.stack([_proj(c[0]) for c in cases])
    b = np.stack([_proj(c[1]) for c in cases])
    got = mesh_reduce.g1_complete_add(fq.limbs_from_numpy(a, "cpu"),
                                      fq.limbs_from_numpy(b, "cpu"))
    got = got.numpy().astype(np.uint64)
    assert np.array_equal(got, np.asarray(jred.g1_complete_add(a, b)))
    for (pa, pb), out in zip(cases, got):
        want = O.ec_to_affine(O.ec_add(pa and O.ec_from_affine(pa),
                                       pb and O.ec_from_affine(pb)))
        assert _affine(out) == (None if want is None
                                else (want[0].n, want[1].n)), (pa, pb)
    assert np.array_equal(mesh_reduce.infinity_point(),
                          jred.infinity_point())


@pytest.mark.parametrize("n_dev,k", [(4, 7), (8, 9)])
def test_g1_butterfly_limbs_equal_jax_order(n_dev, k):
    """Infinity padding (7 keys on 4 slots, 9 on 8) and the oracle sum."""
    pts_int = [O.ec_mul(O.G1_GEN, 3 * i + 1) for i in range(k)]
    pts = np.stack([_proj(O.ec_to_affine(p)) for p in pts_int])
    mesh = torch_env.make_mesh(n_dev, "cpu")
    got = mesh_reduce.mesh_aggregate_g1(pts, mesh)

    want = _jax_butterfly(pts, n_dev, jred.infinity_point((n_dev,)),
                          _JAX_G1_ADD)
    assert np.array_equal(got, want)
    acc = None
    for p in pts_int:
        acc = O.ec_add(acc, p)
    aff = O.ec_to_affine(acc)
    assert _affine(got) == (aff[0].n, aff[1].n)


@pytest.mark.parametrize("monoid", ["fq12", "g1"])
def test_butterflies_equal_the_jax_package_mesh_calls(monoid):
    """The port's butterfly and the JAX package's own (its shard_map over
    4 of the conftest's virtual CPU devices) on the same inputs, limb for
    limb: 3 Fq12 elements (one a slot, identity padding) and 7 G1 points
    (two a slot, infinity padding)."""
    mesh = torch_env.make_mesh(4, "cpu")
    jmesh = jax_env.get_mesh("4")
    if monoid == "fq12":
        xs = _rand_fq12(random.Random(41), 3)
        got = mesh_rlc.mesh_fq12_product(xs, mesh)
        want = jmesh_rlc.mesh_fq12_product(xs, jmesh)
    else:
        xs = np.stack([_proj(O.ec_to_affine(O.ec_mul(O.G1_GEN, 5 * i + 2)))
                       for i in range(7)])
        got = mesh_reduce.mesh_aggregate_g1(xs, mesh)
        want = jred.mesh_aggregate_g1(xs, jmesh)
    assert np.array_equal(got, np.asarray(want).astype(np.uint64))


def test_aggregate_pubkeys_bytes_equal_the_oracle():
    """A committee's aggregate, ``[P, -P]`` (the infinity encoding) and
    an invalid key (raises as the oracle does), on a 4-slot CPU mesh and
    a (2, 2) one."""
    bls.use_py_ecc()
    mesh = torch_env.make_mesh(4, "cpu")
    grid = torch_env.make_mesh(4, "cpu", ("host", "chip"), (2, 2))
    committee = [bls.SkToPk(sk) for sk in range(1, 12)]
    want = bls.AggregatePKs(committee)
    assert mesh_reduce.aggregate_pubkeys(committee, mesh) == want
    assert mesh_reduce.aggregate_pubkeys(committee, grid) == want
    pk = bls.SkToPk(5)
    neg = bls.SkToPk(O.R - 5)
    assert mesh_reduce.aggregate_pubkeys([pk, neg], mesh) == \
        bls.AggregatePKs([pk, neg]) == O.g1_to_bytes(None)
    bad = b"\xa0" + b"\x01" * 47
    with pytest.raises(ValueError):
        bls.AggregatePKs([pk, bad])
    with pytest.raises(ValueError):
        mesh_reduce.aggregate_pubkeys([pk, bad], mesh)
    with pytest.raises(ValueError):
        mesh_reduce.aggregate_pubkeys([], mesh)


def test_a_butterfly_round_sends_before_it_multiplies():
    """Every slot's copy of a round is issued before any slot's product:
    a monoid that records its operands sees only the previous round's
    values."""
    mesh = torch_env.make_mesh(4, "cpu")
    seen = []

    def op(a, b):
        seen.append((int(a), int(b)))
        return a * 10 + b

    vals = [torch.tensor(i + 1) for i in range(4)]
    out = mesh_rlc.butterfly_reduce(vals, mesh, op)
    assert seen[:4] == [(1, 2), (2, 1), (3, 4), (4, 3)]
    assert seen[4:] == [(12, 34), (21, 43), (34, 12), (43, 21)]
    assert int(out[0]) == 12 * 10 + 34
