"""The port's assembler schedulers (consensus_specs_tpu_torch/ops/vm.py)
against each other and against the JAX package, on the CPU.

The native scheduler (csrc/vm_sched.c, built with the host C compiler at
first use), the pure-Python scheduler and the legacy list scheduler must
emit bit-identical programs (instruction tensors, register maps, schedule
metadata), and each the JAX package's ``instr`` / ``input_regs`` /
``output_regs`` for every registry builder at its small tier-1 shape and
for random programs; the schedule written back onto the IR equals the
JAX package's annotations; the pure-Python path warns once a process
when the native scheduler is missing. (The mirror of
tests/test_vm_scheduler.py's and test_vm_compile.py's non-slow cases.)
"""
import random

import numpy as np
import pytest

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.ops import vm as jvm, vmlib as jvmlib  # noqa: E402
from consensus_specs_tpu_torch.ops import fq, vm, vmlib  # noqa: E402
from consensus_specs_tpu_torch.utils import bls12_381 as O  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

SHAPE = dict(w_mul=96, w_lin=192, pad_steps_to=256, pad_regs_to=64)

# every registry kind at its smallest meaningful shape (the JAX test's)
SMALL_SHAPES = [
    ("miller_product", 1, 1),
    ("aggregate_verify", 2, 1),
    ("rlc_combine", 2, 1),
    ("hard_part", 0, 1),
    ("hard_part_windowed", 0, 1),
    ("hard_part_frobenius", 0, 1),
    ("g1_subgroup", 0, 1),
    ("g2_subgroup", 0, 1),
    ("h2g_finish", 0, 1),
]


def _assert_programs_identical(p1, p2, meta=True):
    assert p1.n_regs == p2.n_regs
    assert p1.n_steps == p2.n_steps
    for a, b in zip(p1.instr, p2.instr):
        assert np.array_equal(a, b)
    assert np.array_equal(p1.input_regs, p2.input_regs)
    assert np.array_equal(p1.output_regs, p2.output_regs)
    assert list(p1.input_names) == list(p2.input_names)
    assert list(p1.output_names) == list(p2.output_names)
    assert p1.const_regs == p2.const_regs
    if meta:
        assert p1.meta == p2.meta


def _three_ways(prog, monkeypatch, **shape):
    """(native, pure-Python, legacy) programs of one IR."""
    native = prog.assemble(**shape)
    with monkeypatch.context() as m:
        m.setattr(vm, "_NATIVE_SCHED", None)
        m.setattr(vm, "_NATIVE_WARNED", True)
        plain = prog.assemble(**shape)
    legacy = prog.assemble_legacy(**shape)
    return native, plain, legacy


def test_native_scheduler_builds_here():
    """The sandbox has a C compiler: the native library builds under
    ``_build/``, named by its source digest, and loads."""
    assert vm.native_sched() is not None
    assert vm.native_library_path().exists()
    assert vm.native_library_path().name.startswith("libvmsched_")


def test_small_shapes_cover_every_builder():
    assert set(vmlib.BUILDERS) == {s[0] for s in SMALL_SHAPES}


@pytest.mark.parametrize("kind,k,fold", SMALL_SHAPES,
                         ids=[s[0] for s in SMALL_SHAPES])
def test_schedules_identical_to_each_other_and_to_jax(kind, k, fold,
                                                      monkeypatch):
    prog = vmlib.BUILDERS[kind](k, fold)
    native, plain, legacy = _three_ways(prog, monkeypatch, **SHAPE)
    _assert_programs_identical(native, plain)
    _assert_programs_identical(native, legacy)
    ref = jvmlib.BUILDERS[kind](k, fold).assemble(**SHAPE)
    _assert_programs_identical(native, ref)


def _random_prog(rng, n_inputs=6, n_ops=300, n_consts=3):
    """A random straight-line program in both packages, op for op: every
    kind, constants, reuse of old values (long live ranges) and dead
    values."""
    progs = (vm.Prog(), jvm.Prog())
    vals = [[p.inp(f"x{i}") for i in range(n_inputs)] for p in progs]
    for c in range(n_consts):
        value = rng.randrange(O.P)
        for p, vs in zip(progs, vals):
            vs.append(p.const(value))
    for _ in range(n_ops):
        op = rng.choice("mmas")
        i, j = rng.randrange(len(vals[0])), rng.randrange(len(vals[0]))
        for vs in vals:
            a, b = vs[i], vs[j]
            vs.append(a * b if op == "m" else a + b if op == "a" else a - b)
    picks = rng.sample(range(n_inputs, len(vals[0])), 4)
    for p, vs in zip(progs, vals):
        for n, i in enumerate(picks):
            p.out(vs[i], f"o{n}")
    return progs


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_schedule_like_jax(seed, monkeypatch):
    rng = random.Random(seed)
    mine, ref = _random_prog(rng)
    shape = dict(w_mul=rng.choice((1, 4, 16)), w_lin=rng.choice((1, 3, 8)),
                 pad_steps_to=rng.choice((1, 16)),
                 pad_regs_to=rng.choice((1, 64)))
    native, plain, legacy = _three_ways(mine, monkeypatch, **shape)
    _assert_programs_identical(native, plain)
    _assert_programs_identical(native, legacy)
    _assert_programs_identical(native, ref.assemble(**shape))
    # the schedule written back onto the IR is the JAX package's
    mine.assemble(**shape)
    for a, b in zip(mine.ops, ref.ops):
        assert (a.step, a.reg, a.last_use_step) == \
            (b.step, b.reg, b.last_use_step)


def test_annotate_writes_schedule_back_onto_ir():
    prog = vmlib.build_g1_subgroup_check(1)
    p1 = prog.assemble(annotate=False, **SHAPE)
    assert all(op.step == -1 for op in prog.ops[:4])  # untouched defaults
    p2 = prog.assemble(**SHAPE)
    _assert_programs_identical(p1, p2)
    scheduled = [op for op in prog.ops if op.kind in (0, 1, 2)]
    assert scheduled and all(op.step >= 0 for op in scheduled)
    assert all(op.reg >= 0 for op in prog.ops)


def test_executed_outputs_equal_across_schedulers(monkeypatch):
    """The three schedules of a registry program run on the plain
    executor give the same limbs (tensor identity implies it; this
    covers the execute plumbing with the native path)."""
    g2 = vmlib.build_g2_subgroup_check(1)
    aff = O.ec_to_affine(O.ec_mul(O.G2_GEN, 7))
    ins = {
        "pt.x.0": fq.to_mont_int(aff[0].c0),
        "pt.x.1": fq.to_mont_int(aff[0].c1),
        "pt.y.0": fq.to_mont_int(aff[1].c0),
        "pt.y.1": fq.to_mont_int(aff[1].c1),
    }
    outs = [vm.execute(p, ins, device="cpu")
            for p in _three_ways(g2, monkeypatch, **SHAPE)]
    for out in outs[1:]:
        for name in outs[0]:
            assert np.array_equal(outs[0][name], out[name])


def test_assemble_warns_once_when_native_scheduler_missing(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(vm, "_NATIVE_SCHED", None)
    monkeypatch.setattr(vm, "_NATIVE_WARNED", False)
    vmlib.build_g2_subgroup_check(1).assemble(**SHAPE)
    err = capsys.readouterr().err
    assert "native scheduler" in err and "vm_sched.c" in err
    vmlib.build_g2_subgroup_check(1).assemble(**SHAPE)
    assert "native scheduler" not in capsys.readouterr().err


def test_no_warning_when_native_scheduler_present(monkeypatch, capsys):
    monkeypatch.setattr(vm, "_NATIVE_SCHED", object())
    monkeypatch.setattr(vm, "_NATIVE_WARNED", False)
    vm._warn_native_missing()
    assert "native scheduler" not in capsys.readouterr().err
    assert vm._NATIVE_WARNED is False


def test_no_compiler_falls_back_to_python(monkeypatch, tmp_path):
    """Without a C compiler the loader returns None (no exception), and
    assembly is the pure-Python scheduler's, bit-identical."""
    monkeypatch.setattr(vm, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(vm, "native_library_path",
                        lambda: tmp_path / "libvmsched_none.so")
    monkeypatch.setattr(vm.shutil, "which", lambda name: None)
    assert vm._load_native_sched() is None
    monkeypatch.setattr(vm, "_NATIVE_SCHED", vm._UNLOADED)
    monkeypatch.setattr(vm, "_NATIVE_WARNED", True)
    prog = vmlib.build_g2_subgroup_check(1)
    assert vm.native_sched() is None
    ref = jvmlib.build_g2_subgroup_check(1).assemble(**SHAPE)
    _assert_programs_identical(prog.assemble(**SHAPE), ref)
