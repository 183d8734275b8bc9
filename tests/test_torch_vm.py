"""The port's VM (consensus_specs_tpu_torch/ops/vm.py, vmlib.py,
cuda_step.py) against the JAX package's, on the CPU.

- Assembly: every builder kind emits the same instruction tensors, const
  template and register maps as the JAX assembler.
- One synthetic step, with reads aliasing writes, equals ``vm._vm_step``.
- Whole programs assembled by the JAX package, carried across with
  ``Program.from_arrays``, give the same output limbs on the port's
  executor as on ``vm.execute`` (interpreter, mode '0').
- Assembled programs never read a register in the step that writes it.
"""
import random

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import vm as jvm, vmlib as jvmlib  # noqa: E402
from consensus_specs_tpu_torch.ops import cuda_step, fq, vm, vmlib  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

_SHAPE = dict(w_mul=96, w_lin=192, pad_steps_to=256, pad_regs_to=64)

# (kind, k) at fold 1 and small k: every kind of the BUILDERS registry
KINDS = [
    ("miller_product", 2),
    ("aggregate_verify", 2),
    ("hard_part", 0),
    ("hard_part_windowed", 0),
    ("hard_part_frobenius", 0),
    ("rlc_combine", 2),
    ("g1_subgroup", 0),
    ("g2_subgroup", 0),
    ("h2g_finish", 0),
]

_ASM = {}


def _assembled(kind, k):
    """(JAX program, port program) for one registry kind, assembled once
    per test process."""
    if (kind, k) not in _ASM:
        ref = jvmlib.BUILDERS[kind](k, 1).assemble(annotate=False, **_SHAPE)
        mine = vmlib.BUILDERS[kind](k, 1).assemble(**_SHAPE)
        _ASM[kind, k] = (ref, mine)
    return _ASM[kind, k]


def _carried(ref) -> vm.Program:
    return vm.Program.from_arrays(
        ref.n_regs, ref.instr, ref.input_regs, ref.input_names,
        ref.output_regs, ref.output_names, ref.const_regs, ref.n_steps)


def _rand_loose(rng, shape, max_bits=401):
    vals = np.zeros(shape + (fq.NUM_LIMBS,), dtype=np.uint64)
    flat = vals.reshape(-1, fq.NUM_LIMBS)
    for i in range(flat.shape[0]):
        flat[i] = fq._int_to_limbs_np(rng.randrange(1 << max_bits))
    return vals


def test_builders_registry_matches_reference():
    assert sorted(vmlib.BUILDERS) == sorted(jvmlib.BUILDERS)
    assert sorted(k for k, _ in KINDS) == sorted(jvmlib.BUILDERS)


@pytest.mark.parametrize("kind,k", KINDS)
def test_assembly_identical_to_reference(kind, k):
    ref, mine = _assembled(kind, k)
    assert mine.n_regs == ref.n_regs and mine.n_steps == ref.n_steps
    for a, b in zip(mine.instr, ref.instr):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(mine.const_template(), ref.const_template())
    assert np.array_equal(mine.input_regs, ref.input_regs)
    assert np.array_equal(mine.output_regs, ref.output_regs)
    assert mine.input_names == ref.input_names
    assert mine.output_names == ref.output_names
    assert mine.const_regs == ref.const_regs


@pytest.mark.parametrize("kind,k", KINDS)
def test_assembled_steps_never_read_what_they_write(kind, k):
    """The allocator frees a register only after the step of its last
    read, so no step of an assembled program reads a register it writes
    (the step kernel does not rely on it: it reads all, then writes)."""
    _, mine = _assembled(kind, k)
    msa, msb, msd, lsa, lsb, _, lsd = mine.instr
    reads = np.concatenate([msa, msb, lsa, lsb], axis=1)
    writes = np.concatenate([msd, lsd], axis=1)
    for s in range(mine.n_steps):
        assert not np.intersect1d(reads[s], writes[s]).size, s
        assert np.unique(writes[s]).size == writes.shape[1], s
    assert not (writes == 0).any()  # register 0 stays zero


def _synthetic_step(seed):
    """The aliasing step of tests/test_ops_pallas_step.py: random operands
    on both units, mixed add/sub lanes, destinations drawn from the same
    registers the step reads."""
    rng = random.Random(seed)
    batch, w_mul, w_lin, n_regs = 3, 8, 16, 64
    regs = _rand_loose(rng, (batch, n_regs))
    msa = np.array([rng.randrange(n_regs) for _ in range(w_mul)], np.int32)
    msb = np.array([rng.randrange(n_regs) for _ in range(w_mul)], np.int32)
    lsa = np.array([rng.randrange(n_regs) for _ in range(w_lin)], np.int32)
    lsb = np.array([rng.randrange(n_regs) for _ in range(w_lin)], np.int32)
    lsub = np.array([rng.random() < 0.5 for _ in range(w_lin)])
    for r in set(lsb[lsub].tolist()):
        regs[:, r] = _rand_loose(rng, (batch,), max_bits=381)
    dests = rng.sample(range(n_regs), w_mul + w_lin)
    msd = np.array(dests[:w_mul], np.int32)
    lsd = np.array(dests[w_mul:], np.int32)
    return regs, (msa, msb, msd, lsa, lsb, lsub, lsd)


@pytest.mark.parametrize("seed", [13, 14])
def test_synthetic_step_matches_vm_step(seed):
    regs, instr = _synthetic_step(seed)
    reads = set(np.concatenate([instr[i] for i in (0, 1, 3, 4)]).tolist())
    assert reads & set(instr[2].tolist() + instr[6].tolist())  # aliased
    want, _ = jvm._vm_step(jnp.asarray(regs),
                           tuple(jnp.asarray(x) for x in instr))
    want = np.asarray(want)

    got = vm._vm_step_plain(fq.limbs_from_numpy(regs, "cpu"),
                            tuple(torch.from_numpy(x) for x in instr))
    assert np.array_equal(got.numpy().astype(np.uint64), want)

    # the step kernel's dispatch: a one-step stream in device_instr form
    dev_instr = tuple(
        torch.from_numpy(np.ascontiguousarray(
            x[None].astype(np.uint8 if x.dtype == bool else np.int32)))
        for x in instr)
    before = cuda_step.LAUNCHES
    got2 = cuda_step.run_steps(fq.limbs_from_numpy(regs, "cpu"), dev_instr)
    assert np.array_equal(got2.numpy().astype(np.uint64), want)
    assert cuda_step.LAUNCHES == before  # CPU tensors launch nothing


def _program_inputs(program, rows, seed):
    rng = random.Random(seed)
    return {
        name: np.stack([fq.to_mont_int(rng.randrange(fq.P))
                        for _ in range(rows)])
        for name in program.input_names
    }


@pytest.mark.parametrize("kind,k", [("hard_part_frobenius", 0),
                                    ("miller_product", 2)])
def test_full_program_matches_vm_execute(kind, k, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    ref, _ = _assembled(kind, k)
    ins = _program_inputs(ref, rows=2, seed=len(kind) + k)
    want = jvm.execute(ref, ins, batch_shape=(2,))
    got = vm.execute(_carried(ref), ins, batch_shape=(2,), device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.uint64
        assert np.array_equal(got[name], np.asarray(want[name])), name


def test_from_arrays_roundtrips_a_port_program():
    _, mine = _assembled("rlc_combine", 2)
    back = vm.Program.from_arrays(
        mine.n_regs, mine.instr, mine.input_regs, mine.input_names,
        mine.output_regs, mine.output_names, mine.const_regs, mine.n_steps)
    for a, b in zip(back.instr, mine.instr):
        assert np.array_equal(a, b)
    assert np.array_equal(back.const_template(), mine.const_template())


def _small_program():
    """y = a*b + a - b over two inputs: a few steps on narrow lanes."""
    p = vm.Prog()
    a, b = p.inp("a"), p.inp("b")
    p.out(a * b + a - b, "y")
    return p.assemble(w_mul=2, w_lin=2)


def test_execute_batch_shape_semantics_and_input_checks():
    prog = _small_program()
    rng = random.Random(1)
    xs = [(rng.randrange(fq.P), rng.randrange(fq.P)) for _ in range(2)]
    ins = {"a": np.stack([fq.to_mont_int(a) for a, _ in xs]),
           "b": np.stack([fq.to_mont_int(b) for _, b in xs])}
    flat = vm.execute(prog, ins, batch_shape=(2,), device="cpu")["y"]
    for row, (a, b) in zip(flat, xs):
        assert fq.from_mont_limbs(row) == (a * b + a - b) % fq.P
    shaped = {n: v.reshape(1, 2, fq.NUM_LIMBS) for n, v in ins.items()}
    out = vm.execute(prog, shaped, batch_shape=(1, 2), device="cpu")["y"]
    assert out.shape == (1, 2, fq.NUM_LIMBS)
    assert np.array_equal(out[0], flat)
    ins["a"] = np.full((2, 15), 1 << 28, np.uint64)
    with pytest.raises(ValueError):
        vm.execute(prog, ins, batch_shape=(2,), device="cpu")


def test_device_instr_rejects_out_of_range_registers():
    prog = _small_program()
    bad = vm.Program.from_arrays(
        prog.n_regs - 1, prog.instr, prog.input_regs, prog.input_names,
        prog.output_regs, prog.output_names, prog.const_regs, prog.n_steps)
    with pytest.raises(ValueError):
        bad.device_instr("cpu")
