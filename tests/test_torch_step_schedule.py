"""The step kernel's split Montgomery product and data flow, on the CPU
(the kernel itself runs only on a card).

``cuda_step.mont_mul_split_emulated`` replays, thread by thread, the
schedule of csrc/mont.cuh ``fq_mont_mul_split``: which thread holds which
limbs and columns, the shuffled a_i and m_i, the 28-bit hand-down of each
round's lowest column, and the shuffled carry rounds. It must give the
limbs of ``fq.mont_mul_plain`` and of the JAX package's
``fq.mont_mul_u64`` exactly, with every accumulator inside 64 bits, at the
loose-bound extremes too. ``cuda_step.run_steps_emulated`` replays the
kernel's data flow (every load before any store, a result stored only
where its slot holds the destination's stamp) with the plain arithmetic;
it must give the plain steps' register file, also where two lanes of a
step write one register (``cuda_step.run_steps_plain_in_lane_order``: the
later lane keeps it, as in the kernel).
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import fq as jfq  # noqa: E402
from consensus_specs_tpu.utils.bls12_381 import P  # noqa: E402
from consensus_specs_tpu_torch.ops import (  # noqa: E402
    cuda_step, fq, vm, vmlib)
from tests.torch_threads import one_thread

one_thread()

_MAXV = np.full(fq.NUM_LIMBS, fq.MASK, dtype=np.uint64)  # 2^420 - 1
_PM1 = fq._int_to_limbs_np(P - 1)
_ZERO = np.zeros(fq.NUM_LIMBS, dtype=np.uint64)
# the largest input the assembler's bound tracker lets a MUL lane see is
# below 2^420; these pairs sit at and near that edge
EDGES = [(_MAXV, _MAXV), (_MAXV, fq.ONE_MONT), (_PM1, _PM1),
         (_ZERO, _MAXV), (fq._int_to_limbs_np((1 << 420) - P), _MAXV),
         (fq._int_to_limbs_np((1 << 402) + 12345), _MAXV)]


def _inputs(kind, seed):
    rng = random.Random(seed)
    if kind == "edges":
        a = np.stack([x for x, _ in EDGES])
        b = np.stack([y for _, y in EDGES])
    elif kind == "loose401":  # loose residues, the VM's usual operands
        a, b = (np.stack([fq._int_to_limbs_np(rng.randrange(1 << 401))
                          for _ in range(24)]) for _ in range(2))
    elif kind == "near_p_multiples":  # k * p +- a little, below 2^420
        a, b = (np.stack([fq._int_to_limbs_np(
            rng.randrange(1, (1 << 420) // P) * P
            + rng.choice((-1, 1)) * rng.randrange(1 << 20))
            for _ in range(24)]) for _ in range(2))
    elif kind == "mask_or_zero":  # every limb 0 or 2^28 - 1
        a, b = (np.array([[rng.choice((0, fq.MASK)) for _ in range(15)]
                          for _ in range(24)], dtype=np.uint64)
                for _ in range(2))
    elif kind == "one_limb":  # one nonzero limb, so one thread's slice
        a, b = (np.zeros((15, 15), dtype=np.uint64) for _ in range(2))
        for i in range(15):
            a[i, i] = rng.randrange(1, 1 << 28)
            b[i, 14 - i] = rng.randrange(1, 1 << 28)
    else:  # any 15 limbs below 2^28: values up to 2^420
        a, b = (np.array([[rng.randrange(1 << 28) for _ in range(15)]
                          for _ in range(24)], dtype=np.uint64)
                for _ in range(2))
    return a.astype(np.uint64), b.astype(np.uint64)


@pytest.mark.parametrize("kind", ["edges", "loose401", "near_p_multiples",
                                  "mask_or_zero", "one_limb", "full_limbs"])
def test_split_product_matches_plain_and_jax(kind):
    a, b = _inputs(kind, 17 + len(kind))
    got = cuda_step.mont_mul_split_emulated(a, b)
    plain = fq.mont_mul_plain(torch.from_numpy(a.astype(np.int64)),
                              torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got, plain.numpy().astype(np.uint64))
    assert np.array_equal(got, np.asarray(jfq.mont_mul_u64(a, b)))
    assert got.max() < (1 << fq.LIMB_BITS)


def test_split_product_broadcasts_and_takes_one_element():
    a, b = _inputs("loose401", 5)
    one = cuda_step.mont_mul_split_emulated(a[0], b[0])
    assert one.shape == (fq.NUM_LIMBS,)
    assert np.array_equal(one, cuda_step.mont_mul_split_emulated(a, b)[0])
    row = cuda_step.mont_mul_split_emulated(a, b[:1])
    assert np.array_equal(row[3], cuda_step.mont_mul_split_emulated(a[3], b[0]))


def test_split_product_guards_its_64_bit_accumulators():
    """Limbs of 2^31 break the overflow audit (15 products of 2^62 in one
    column): the emulation refuses rather than wrap."""
    wide = np.full(fq.NUM_LIMBS, 1 << 31, dtype=np.uint64)
    with pytest.raises(OverflowError):
        cuda_step.mont_mul_split_emulated(wide, wide)


# two lanes of a step that write one register, as positions in the step's
# destinations (MUL lanes first) for a MUL width: the later lane's result
# must stay
SHARED_DESTS = {"mul_lin": lambda w_mul: (0, w_mul),
                "mul_mul": lambda w_mul: (1, w_mul - 1),
                "lin_lin": lambda w_mul: (w_mul, -1)}


def _aliasing_stream(rng, n_steps, w_mul, w_lin, n_regs, shared):
    """Instruction rows whose reads alias the previous step's writes and
    the same step's, and in which, every other step, the two lanes that
    ``SHARED_DESTS[shared]`` names write one register."""
    first, later = SHARED_DESTS[shared](w_mul)
    rows, prev = [], rng.choice(n_regs, w_mul + w_lin, replace=False)
    for s in range(n_steps):
        dests = rng.choice(n_regs, w_mul + w_lin, replace=False)
        if s % 2 == 1:
            dests[later] = dests[first]
        reads = rng.integers(0, n_regs, size=(4, max(w_mul, w_lin)))
        reads[:, :3] = dests[:3]
        reads[:, 3:6] = prev[w_mul - 1:w_mul + 2]
        rows.append([reads[0, :w_mul], reads[1, :w_mul], dests[:w_mul],
                     reads[2, :w_lin], reads[3, :w_lin],
                     (rng.random(w_lin) < 0.5).astype(np.uint8),
                     dests[w_mul:]])
        prev = dests
    return tuple(torch.from_numpy(np.stack([r[i] for r in rows]).astype(
        np.uint8 if i == 5 else np.int32)) for i in range(7))


def _loose_regs(rng, rows, n_regs):
    """Random registers below 2^381 (limbs 0..12 uniform, limb 13 below
    2^17, limb 14 zero)."""
    limbs = rng.integers(0, 1 << 28, size=(rows, n_regs, 15), dtype=np.int64)
    limbs[..., 13] &= (1 << 17) - 1
    limbs[..., 14] = 0
    return torch.from_numpy(limbs)


@pytest.mark.parametrize("shared", sorted(SHARED_DESTS))
@pytest.mark.parametrize("rows,n_steps,w_mul,w_lin", [
    (1, 2, 4, 8), (2, 24, 8, 16), (3, 40, 6, 12)])
def test_emulated_data_flow_matches_plain_steps(rows, n_steps, w_mul, w_lin,
                                                shared):
    """The kernel's data flow (every load before any store, stores only
    where the slot holds the destination's stamp) gives the plain steps'
    register file exactly, two lanes of one unit that write one register
    leaving the later lane's result."""
    rng = np.random.default_rng(100 * rows + n_steps + len(shared))
    n_regs = 3 * (w_mul + w_lin)
    instr = _aliasing_stream(rng, n_steps, w_mul, w_lin, n_regs, shared)
    regs = _loose_regs(rng, rows, n_regs)
    want = cuda_step.run_steps_plain_in_lane_order(regs, instr)
    got = cuda_step.run_steps_emulated(regs.clone(), instr)
    assert torch.equal(got, want)
    if shared == "mul_lin":  # two scatters, MUL then LIN: defined as is
        assert torch.equal(want, vm._run_steps_plain(regs.clone(), instr))


def test_plain_in_lane_order_keeps_the_later_lane():
    """Two MUL lanes and two LIN lanes of one step share a destination:
    the later lane's result stays, and no register past the file's end
    is left behind."""
    rng = np.random.default_rng(31)
    w_mul, w_lin, n_regs = 4, 8, 40
    instr = _aliasing_stream(rng, 2, w_mul, w_lin, n_regs, "mul_mul")
    msd, lsd = instr[2][1], instr[6][1]
    lsd[3] = lsd[1]
    regs = _loose_regs(rng, 2, n_regs)
    got = cuda_step.run_steps_plain_in_lane_order(regs, instr)
    assert got.shape == regs.shape
    after0 = vm._run_steps_plain(regs.clone(), tuple(x[:1] for x in instr))
    msa, msb, lsa, lsb, lsub = (instr[i][1].long() for i in (0, 1, 3, 4, 5))
    mul = fq.mont_mul_plain(after0[:, msa[w_mul - 1]], after0[:, msb[w_mul - 1]])
    lin = vm._lin_plain(after0[:, lsa[3]], after0[:, lsb[3]], lsub[3])
    if int(msd[w_mul - 1]) not in lsd.tolist():
        assert torch.equal(got[:, int(msd[w_mul - 1])], mul)
    assert torch.equal(got[:, int(lsd[3])], lin)


def test_emulated_data_flow_on_an_assembled_program():
    """The first 128 steps of an assembled program of the verify path."""
    prog = vmlib.BUILDERS["miller_product"](2, 1).assemble(
        w_mul=96, w_lin=192, pad_steps_to=256, pad_regs_to=64)
    rng = np.random.default_rng(8)
    stacked = np.stack([np.stack([
        fq._int_to_limbs_np(int(rng.integers(1, 1 << 62)) ** 6 % P)
        for _ in prog.input_names]) for _ in range(2)])
    regs = vm._init_regs(prog, stacked.astype(np.uint64), "cpu")
    head = tuple(x[:128] for x in prog.device_instr("cpu"))
    want = vm._run_steps_plain(regs.clone(), head)
    assert torch.equal(cuda_step.run_steps_emulated(regs.clone(), head), want)
