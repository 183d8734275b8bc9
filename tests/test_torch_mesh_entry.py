"""The ``mesh=`` of the port's verify entry points beyond the per-item
and RLC batches on a 4-slot CPU mesh, each held against the same call
unsharded: the scale plane's ``verify_slot`` and ``verify_slot_flat`` and
``batch_aggregate_verify``. Every sharded call must reach ``vm.execute``
with the mesh and give the unsharded call's verdicts and accounting.
Last, a sharded RLC combine whose butterfly fails raises instead of
answering off the mesh."""
import random

import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu_torch.ops import bls_backend as bb
from consensus_specs_tpu_torch.ops import fq, mesh_rlc, vm, vmlib
from consensus_specs_tpu_torch.scale import hierarchy
from consensus_specs_tpu_torch.scale import registry
from consensus_specs_tpu_torch.utils import bls
from consensus_specs_tpu_torch.utils import bls12_381 as O
from consensus_specs_tpu_torch.utils import torch_env

one_thread()

CPU = torch.device("cpu")


@pytest.fixture()
def mesh():
    return torch_env.make_mesh(4, CPU)


@pytest.fixture()
def execute_meshes(monkeypatch):
    """The ``mesh`` of every ``vm.execute`` call, in order."""
    seen = []
    real = vm.execute

    def spy(*args, **kwargs):
        seen.append(kwargs.get("mesh"))
        return real(*args, **kwargs)

    monkeypatch.setattr(vm, "execute", spy)
    return seen


def _off_subgroup_g2() -> bytes:
    """A G2 point on the twist outside the order-r subgroup."""
    x0 = 3
    while True:
        x = O.Fq2(x0, 1)
        y = (x * x * x + O.B_G2).sqrt()
        if y is not None:
            pt = O.ec_from_affine((x, y))
            if not O.is_in_g2_subgroup(pt):
                return O.g2_to_bytes(pt)
        x0 += 1


def _slot_items(bad=None):
    reg = registry.Registry(64, seed=13, slots_per_epoch=8, target_size=2,
                            shuffle_rounds=4)
    items = hierarchy.committee_items(reg, slot=3)
    if bad is not None:
        items[bad] = hierarchy.corrupt_item(items[bad])
    return items


def test_verify_slot_sharded_equals_unsharded(mesh, execute_meshes):
    """Two committees of the all-valid slot: the unsharded report's
    verdicts, combines, bisections and final exponentiations."""
    bls.use_py_ecc()
    items = _slot_items()[:2]
    want = hierarchy.verify_slot(items, slot=3, device=CPU,
                                 rng=random.Random(5))
    got = hierarchy.verify_slot(items, slot=3, mesh=mesh,
                                rng=random.Random(5))
    assert mesh in execute_meshes
    assert got.verdicts.tolist() == want.verdicts.tolist()
    assert got.all_valid
    assert (got.combines, got.bisections, got.final_exps_per_slot) == \
        (want.combines, want.bisections, want.final_exps_per_slot)


def test_verify_slot_flat_sharded_equals_unsharded(mesh, execute_meshes):
    """The slot with committee 2 corrupted, every committee finalized on
    its own: the unsharded verdicts."""
    bls.use_py_ecc()
    items = _slot_items(bad=2)
    want = hierarchy.verify_slot_flat(items, device=CPU)
    got = hierarchy.verify_slot_flat(items, mesh=mesh)
    assert mesh in execute_meshes
    assert got.tolist() == want.tolist()
    assert got.tolist() == [i != 2 for i in range(len(items))]


def test_batch_aggregate_verify_sharded_equals_unsharded(mesh,
                                                         execute_meshes):
    """Distinct messages a key: valid, one message swapped, an
    off-subgroup signature."""
    bls.use_py_ecc()
    m0, m1 = b"\x11" * 32, b"\x22" * 32
    pks = [bls.SkToPk(41), bls.SkToPk(42)]
    sig = bls.Aggregate([bls.Sign(41, m0), bls.Sign(42, m1)])
    args = ([pks] * 3, [[m0, m1], [m0, m0], [m0, m1]],
            [sig, sig, _off_subgroup_g2()])
    want = bb.batch_aggregate_verify(*args, device=CPU)
    got = bb.batch_aggregate_verify(*args, mesh=mesh)
    assert mesh in execute_meshes
    assert list(got) == list(want) == [True, False, False]


def test_a_failed_butterfly_raises(mesh, monkeypatch):
    """A sharded combine whose butterfly fails raises out of
    ``_rlc_combine_vm`` (and so out of ``batch_verify_rlc``): no verdict
    comes from chunk products multiplied off the mesh. The combine's
    program is stubbed (its outputs are not read before the butterfly);
    the unsharded combine of the same inputs does not reach the
    butterfly."""
    calls = []

    def broken(products, mesh):
        calls.append(products.shape)
        raise RuntimeError("injected butterfly failure")

    def zeros(program, inputs, batch_shape=(), device=None, mesh=None):
        rows = batch_shape[0]
        return {name: np.zeros((rows, fq.NUM_LIMBS), dtype=np.uint64)
                for name in program.output_names}

    monkeypatch.setattr(mesh_rlc, "mesh_fq12_product", broken)
    monkeypatch.setattr(vm, "execute", zeros)
    fs = np.zeros((2, 12, fq.NUM_LIMBS), dtype=np.uint64)
    fs[:, 0] = fq.to_mont_int(1)
    bits = np.ones((2, vmlib.RLC_BITS), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="injected butterfly"):
        bb._rlc_combine_vm(fs, bits, CPU, mesh=mesh)
    assert calls == [(2, 12, fq.NUM_LIMBS)]
    bb._rlc_combine_vm(fs, bits, CPU)
    assert len(calls) == 1
