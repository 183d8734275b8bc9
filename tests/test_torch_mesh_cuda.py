"""The mesh path on the card (``cuda`` marker: these skip without a CUDA
device, and the two-card cases without two cards). Two slots on one card,
each on its own stream: ``vm.execute(mesh=)`` equal to the unsharded call
limb for limb with one step-kernel launch a slot, and the butterflies
equal to the same calls on a CPU mesh. Two distinct cards: both kernels
launched on a tensor of a card that is not the current device, and a
mesh over the two cards. This file imports no JAX, so it runs on a GPU
machine with ``python -m pytest tests/test_torch_mesh_cuda.py -m cuda``.
"""
import random

import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu_torch.ops import (
    cuda_fq, cuda_step, fq, mesh_reduce, mesh_rlc, vm,
)
from consensus_specs_tpu_torch.utils import bls12_381 as O
from consensus_specs_tpu_torch.utils import torch_env

one_thread()

pytestmark = pytest.mark.cuda


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.cuda.device_count()


def _program_and_inputs(rows):
    prog = vm.Prog()
    a, b, c = (prog.inp(n) for n in "abc")
    acc = (a * b + prog.const(12345)) - c
    for _ in range(4):
        acc = acc * acc + (b - a)
    prog.out(acc, "r")
    assembled = prog.assemble(w_mul=64, w_lin=64, pad_steps_to=256,
                              pad_regs_to=64)
    rng = random.Random(5)
    ins = {n: np.stack([fq.to_mont_int(rng.randrange(O.P))
                        for _ in range(rows)]) for n in "abc"}
    return assembled, ins


def _butterfly_inputs():
    rng = random.Random(11)
    fs = np.stack([np.stack([fq.to_mont_int(rng.randrange(O.P))
                             for _ in range(12)]) for _ in range(5)])
    pts = np.zeros((5, 3, fq.NUM_LIMBS), dtype=np.uint64)
    for i in range(5):
        x, y = O.ec_to_affine(O.ec_mul(O.G1_GEN, rng.randrange(1, O.R)))
        pts[i] = [fq.to_mont_int(x.n), fq.to_mont_int(y.n),
                  fq.to_mont_int(1)]
    return fs, pts


def _check_mesh(mesh):
    assembled, ins = _program_and_inputs(4)
    want = vm.execute(assembled, ins, batch_shape=(4,), device="cpu")
    launches = cuda_step.LAUNCHES
    got = vm.execute(assembled, ins, batch_shape=(4,), mesh=mesh)
    assert cuda_step.LAUNCHES - launches == mesh.size
    assert np.array_equal(got["r"], want["r"])
    fs, pts = _butterfly_inputs()
    cpu = torch_env.make_mesh(mesh.size, "cpu")
    k2 = cuda_fq.LAUNCHES
    assert np.array_equal(mesh_rlc.mesh_fq12_product(fs, mesh),
                          mesh_rlc.mesh_fq12_product(fs, cpu))
    assert np.array_equal(mesh_reduce.mesh_aggregate_g1(pts, mesh),
                          mesh_reduce.mesh_aggregate_g1(pts, cpu))
    assert cuda_fq.LAUNCHES > k2


def test_two_slots_on_one_card(cards):
    mesh = torch_env.Mesh(np.array([torch.device("cuda", 0)] * 2,
                                   dtype=object))
    assert mesh.distinct_devices == 1
    assert mesh.slots[0].stream != mesh.slots[1].stream
    _check_mesh(mesh)


def test_kernels_on_a_card_that_is_not_current(cards):
    """Both launches name their tensor's card: with cuda:0 current, a
    tensor on cuda:1 runs there and equals the plain version."""
    if cards < 2:
        pytest.skip("needs two cards")
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 28, size=(64, fq.NUM_LIMBS), dtype=np.int64)
    b = rng.integers(0, 1 << 28, size=(64, fq.NUM_LIMBS), dtype=np.int64)
    want = fq.mont_mul_plain(torch.from_numpy(a), torch.from_numpy(b))
    assembled, ins = _program_and_inputs(2)
    plain = vm.execute(assembled, ins, batch_shape=(2,), device="cpu")
    with torch.cuda.device(0):
        far = torch.device("cuda", 1)
        got = cuda_fq.mont_mul(torch.from_numpy(a).to(far),
                               torch.from_numpy(b).to(far))
        assert torch.equal(got.cpu(), want)
        out = vm.execute(assembled, ins, batch_shape=(2,), device=far)
        assert np.array_equal(out["r"], plain["r"])


def test_mesh_over_two_cards(cards):
    if cards < 2:
        pytest.skip("needs two cards")
    mesh = torch_env.make_mesh(2)
    assert mesh.distinct_devices == 2
    _check_mesh(mesh)
