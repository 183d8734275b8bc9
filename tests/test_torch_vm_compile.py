"""The port's fused straight-line lowering (ops/vm_compile.py) on the CPU,
and on the card where there is one: the mirror of tests/test_vm_compile.py's
non-slow cases.

Fused equals the interpreter equals the exact-int IR oracle
(``vm_analysis.eval_ir``, held equal to the JAX package's in
tests/test_torch_vm_analysis_rules.py) limb for limb on synthetic programs
and a registry program, scalar and on the batch axis, with structural
dedup and scan blocks on and off, at every chunking; a failure falls back
to the interpreter with a ``vm/fused_fallback`` flight event; ``auto``
follows the measured winner, across processes through the plan's
persisted measurements, and only at built signatures; the plan and
structure cache entries' stale rules, prune and re-derivation; the env
knobs warn once; the background warm flips ``auto``; the fixed carry pass
equals ``fq._carry_limbs``; a capture's launch tally is its thread's
alone. This file imports no JAX, so its ``cuda`` tests run on a GPU
machine with ``python -m pytest tests/test_torch_vm_compile.py -m cuda``.
"""
import os
import pickle
import random
import threading
import time

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.ops import (
    bls_backend as bb, cuda_fq, fq, vm, vm_analysis, vm_compile, vmlib,
)
from consensus_specs_tpu_torch.utils import bls12_381 as O
from tests.torch_threads import one_thread

one_thread()

rng = random.Random(31)

BUCKET = dict(w_mul=64, w_lin=64, pad_steps_to=256, pad_regs_to=64)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_fused_state():
    vm_compile.reset_fused_state()
    yield
    vm_compile.reset_fused_state()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Montgomery kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _mixed_prog(depth=6):
    """Every op kind, a constant, input reuse, and enough depth to span
    several tiny chunks."""
    prog = vm.Prog()
    a = prog.inp("a")
    b = prog.inp("b")
    c = prog.inp("c")
    k = prog.const(0x1234567890ABCDEF ^ O.P // 3)
    acc = a * b + k
    other = (b - c) * (a + k)
    for _ in range(depth):
        acc = acc * acc + other
        other = other * b - a
    prog.out(acc, "acc")
    prog.out(other, "other")
    return prog


def _periodic_prog(iters=10):
    """A ladder: one loop body stamped ``iters`` times, a constant of its
    own an iteration (constants dedup as runtime operands)."""
    prog = vm.Prog()
    acc = prog.inp("acc")
    other = prog.inp("other")
    for i in range(iters):
        k = prog.const(1000003 * (i + 1))
        acc = acc * acc + other * k
        other = other * other - acc
    prog.out(acc, "acc")
    prog.out(other, "other")
    return prog


def _rand_inputs(prog, rows=0):
    ints = [{n: rng.randrange(O.P) for n in prog.input_names}
            for _ in range(max(1, rows))]
    if rows:
        arrs = {n: np.stack([fq.to_mont_int(row[n]) for row in ints])
                for n in ints[0]}
    else:
        arrs = {n: fq.to_mont_int(v) for n, v in ints[0].items()}
    return ints, arrs


def _run_both(assembled, arrs, batch_shape, monkeypatch, device=CPU):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    out_i = vm.execute(assembled, arrs, batch_shape=batch_shape,
                       device=device)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
    out_f = vm.execute(assembled, arrs, batch_shape=batch_shape,
                       device=device)
    return out_i, out_f


def _check(prog, ints, out_i, out_f, rows=0):
    for name in out_i:
        assert np.array_equal(out_i[name], out_f[name]), name
    for r in range(max(1, rows)):
        want = vm_analysis.eval_ir(prog, ints[r])
        for name, w in want.items():
            got = out_f[name][r] if rows else out_f[name]
            assert fq.limbs_to_int(got) == w, name


def _with_key(assembled, fp="cafe0123"):
    assembled.meta["fused_key"] = ("synthetic", 0, 1, fp)
    return assembled


def test_fused_identity_and_oracle_scalar(monkeypatch):
    prog = _mixed_prog()
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "5")
    out_i, out_f = _run_both(assembled, arrs, (), monkeypatch)
    _check(prog, ints, out_i, out_f)
    assert vm_compile._COUNTERS["executions"] == 1
    assert vm_compile._COUNTERS["fallbacks"] == 0


def test_fused_identity_batch_axis(monkeypatch):
    prog = _mixed_prog(depth=4)
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog, rows=3)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    out_i, out_f = _run_both(assembled, arrs, (3,), monkeypatch)
    _check(prog, ints, out_i, out_f, rows=3)


@pytest.mark.parametrize("chunk", ["1", "3", "1000000"])
def test_chunk_boundary_liveness(monkeypatch, chunk):
    """Identity at every chunking: a carry boundary after every level, and
    one chunk with none."""
    prog = _mixed_prog(depth=3)
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", chunk)
    out_i, out_f = _run_both(assembled, arrs, (), monkeypatch)
    _check(prog, ints, out_i, out_f)


def test_fused_f12_formula_vs_oracle(monkeypatch):
    prog = vm.Prog()
    x = [prog.inp(f"x{i}") for i in range(12)]
    y = [prog.inp(f"y{i}") for i in range(12)]
    for i, c in enumerate(vmlib.f12_mul(prog, x, y)):
        prog.out(c, f"m{i}")
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "8")
    out_i, out_f = _run_both(assembled, arrs, (), monkeypatch)
    _check(prog, ints, out_i, out_f)


@pytest.mark.parametrize("dedup,superop", [("1", "auto"), ("1", "2"),
                                           ("1", "off"), ("0", "auto")])
def test_registry_program_fused_identity(monkeypatch, dedup, superop):
    """g2_subgroup at the production shape, on 2 rows, through every
    dedup and scan-block setting."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_DEDUP", dedup)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_SUPEROP", superop)
    prog = vmlib.build_g2_subgroup_check(1)
    assembled = prog.assemble(w_mul=bb.W_MUL, w_lin=bb.W_LIN,
                              pad_steps_to=bb.PAD_STEPS,
                              pad_regs_to=bb._pow2(64))
    ints, arrs = _rand_inputs(prog, rows=2)
    out_i, out_f = _run_both(assembled, arrs, (2,), monkeypatch)
    _check(prog, ints, out_i, out_f, rows=2)
    st = vm_compile._FUSED[id(assembled)].struct_stats
    if dedup == "0":
        assert st["distinct_structs"] == st["chunks"]
    else:
        assert st["distinct_structs"] < st["chunks"]
    assert (st["superop_segments"] > 0) == (dedup == "1" and superop != "off")


def test_zero_step_program_selects_its_inputs(monkeypatch):
    prog = vm.Prog()
    a = prog.inp("a", bound=1 << 381)
    prog.outputs.append(a.idx)  # an output that is an input, no ALU op
    prog.output_names.append("a")
    assembled = prog.assemble(**BUCKET)
    _, arrs = _rand_inputs(prog, rows=2)
    out_i, out_f = _run_both(assembled, arrs, (2,), monkeypatch)
    assert np.array_equal(out_f["a"], arrs["a"])
    assert np.array_equal(out_i["a"], out_f["a"])


def test_carry_fixed_equals_carry_limbs():
    """The fixed carry-lookahead pass against the loop of carry passes,
    on random sums and on the ripple's worst cases (a carry through every
    limb)."""
    g = np.random.default_rng(3)
    t = g.integers(0, 1 << 31, size=(64, 3, 15), dtype=np.int64)
    t[0, 0, :] = fq.MASK
    t[0, 0, 0] = 1 << 28  # one carry that ripples through every limb
    t[1, 0, :] = fq.MASK + 1
    t[2, 0, :] = (1 << 30) - 1
    t = torch.from_numpy(t)
    assert torch.equal(vm_compile._carry_fixed(t.clone()),
                       fq._carry_limbs(t.clone()))


def test_fused_fallback_flight_event(monkeypatch):
    """A failure in the fused route falls back to the interpreter (right
    outputs, no exception) and journals vm/fused_fallback."""
    from consensus_specs_tpu_torch.obs import flight

    prog = _mixed_prog(depth=2)
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    flight.reset_global()

    def boom(*a, **kw):
        raise RuntimeError("injected lowering failure")

    monkeypatch.setattr(vm_compile, "run_fused", boom)
    out = vm.execute(assembled, arrs, device="cpu")
    want = vm_analysis.eval_ir(prog, ints[0])
    for name, w in want.items():
        assert fq.limbs_to_int(out[name]) == w
    assert vm_compile._COUNTERS["fallbacks"] == 1
    events = [e for e in flight.global_recorder().events()
              if e.get("plane") == "vm" and e.get("kind") == "fused_fallback"]
    assert events, "fused_fallback flight event missing"
    assert "injected lowering failure" in events[-1]["data"]["error"]
    flight.reset_global()


def test_auto_routing_uses_measured_winner(monkeypatch):
    assembled = _mixed_prog(depth=2).assemble(**BUCKET)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    assert not vm_compile.use_fused(assembled)  # no measurements: interp
    assembled._exec_stats = {"fused_ms_row": 1.0, "interp_ms_row": 5.0}
    assert vm_compile.use_fused(assembled)
    assembled._exec_stats = {"fused_ms_row": 5.0, "interp_ms_row": 1.0}
    assert not vm_compile.use_fused(assembled)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    assembled._exec_stats = {"fused_ms_row": 1.0, "interp_ms_row": 5.0}
    assert not vm_compile.use_fused(assembled)  # pinned interp wins
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
    assembled._exec_stats = {}
    assert vm_compile.use_fused(assembled)  # pinned fused builds on demand


def test_auto_routing_persists_across_processes(monkeypatch, tmp_path):
    """The measured pair rides the program's disk plan: a new Program
    with the same cache identity (a fresh process) adopts it, and auto
    serves fused only at a signature built in-process."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_CACHE", str(tmp_path))
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "6")
    prog = _mixed_prog(depth=2)
    assembled = _with_key(prog.assemble(**BUCKET))
    _, arrs = _rand_inputs(prog)
    sig = vm_compile.shape_sig((), "cpu")

    for mode in ("interp", "interp", "fused", "fused"):
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", mode)
        vm.execute(assembled, arrs, device="cpu")
    st = assembled._exec_stats
    assert st.get("fused_ms_row") is not None
    assert st.get("interp_ms_row") is not None
    plan_path = vm_compile._plan_cache_path(assembled)
    assert plan_path.startswith(str(tmp_path)) and os.path.exists(plan_path)
    with open(plan_path, "rb") as fh:
        plan = pickle.load(fh)
    assert {"fused_ms_row", "interp_ms_row"} <= set(plan["measured"])

    plan["measured"] = {"fused_ms_row": 1.0, "interp_ms_row": 9.0}
    with open(plan_path, "wb") as fh:
        pickle.dump(plan, fh)
    vm_compile.reset_fused_state()
    fresh = _with_key(prog.assemble(**BUCKET))
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    assert vm_compile.use_fused(fresh)  # the winner adopted off the disk
    assert not vm_compile.use_fused(fresh, shape_sig=sig)  # not built yet
    before = vm_compile._COUNTERS["executions"]
    out_cold = vm.execute(fresh, arrs, device="cpu")
    assert vm_compile._COUNTERS["executions"] == before  # interp served
    vm_compile.warm_fused(fresh, (), device="cpu")
    assert vm_compile.use_fused(fresh, shape_sig=sig)
    out_a = vm.execute(fresh, arrs, device="cpu")
    assert vm_compile._COUNTERS["executions"] == before + 1  # fused now
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    out_i = vm.execute(fresh, arrs, device="cpu")
    for name in out_i:
        assert np.array_equal(out_a[name], out_i[name])
        assert np.array_equal(out_cold[name], out_i[name])

    plan["measured"] = {"fused_ms_row": 9.0, "interp_ms_row": 1.0}
    with open(plan_path, "wb") as fh:
        pickle.dump(plan, fh)
    vm_compile.reset_fused_state()
    fresh2 = _with_key(prog.assemble(**BUCKET))
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    assert not vm_compile.use_fused(fresh2)


def test_warm_fused_reports_build_seconds(monkeypatch):
    assembled = _mixed_prog(depth=2).assemble(**BUCKET)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "6")
    assert vm_compile.warm_fused(assembled, (), device="cpu") > 0.0
    assert vm_compile.warm_fused(assembled, (), device="cpu") == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vm_compile.warm_fused(assembled, ())  # None means the card


# -- the fused cache keys, stale rules and prune --------------------------


def _plan_name(lowering=None, version=None, kind="g2_subgroup", fp=None,
               chunk=24):
    lowering = vm_compile.LOWERING_VERSION if lowering is None else lowering
    version = bb._VM_CACHE_VERSION if version is None else version
    fp = bb._program_fingerprint(kind) if fp is None else fp
    return (f"fusedplan_l{lowering}_v{version}_{fp}_{kind}"
            f"_k0_f1_w96x192_p1024_c{chunk}.pkl")


def _struct_name(key="ab" * 12, lowering=None):
    lowering = vm_compile.LOWERING_VERSION if lowering is None else lowering
    return f"fusedstruct_l{lowering}_{key}.pkl"


def test_fused_cache_stale_rules():
    assert not bb._vm_cache_entry_stale(_plan_name())
    # a lowering bump evicts fused plans, not interpreter programs
    assert bb._vm_cache_entry_stale(
        _plan_name(lowering=vm_compile.LOWERING_VERSION + 1))
    assert bb._vm_cache_entry_stale(
        _plan_name(version=bb._VM_CACHE_VERSION + 1))
    assert bb._vm_cache_entry_stale(_plan_name(fp="00000000"))
    assert not bb._vm_cache_entry_stale(
        _plan_name(kind="not_a_builder", fp="00000000"))
    assert not bb._vm_cache_entry_stale(_struct_name())
    assert bb._vm_cache_entry_stale(
        _struct_name(lowering=vm_compile.LOWERING_VERSION + 1))
    # malformed names of either prefix are kept, never crash
    assert not bb._vm_cache_entry_stale("fusedplan_weird.pkl")
    assert not bb._vm_cache_entry_stale("fusedstruct_weird.pkl")


def _write_plan_entry(tmp_path, refs, name=None):
    p = tmp_path / (name or _plan_name())
    with open(p, "wb") as fh:
        pickle.dump({"format": 2, "struct_refs": list(refs)}, fh)
    return p


def test_prune_evicts_stale_fused_entries(tmp_path):
    stale = tmp_path / _plan_name(lowering=vm_compile.LOWERING_VERSION + 1)
    interp = tmp_path / (
        f"v{bb._VM_CACHE_VERSION}_{bb._program_fingerprint('g2_subgroup')}"
        "_g2_subgroup_k0_f1_w96x192_p256.pkl")
    for p in (stale, interp):
        p.write_bytes(b"x" * 64)
    fresh = _write_plan_entry(tmp_path, [])
    res = bb.prune_vm_cache(max_age_days=0, max_bytes=0,
                            cache_dir=str(tmp_path))
    assert not stale.exists()
    assert fresh.exists() and interp.exists()
    assert res["evicted"] == 1 and res["kept"] == 2


def test_prune_keeps_referenced_structs_evicts_orphans(tmp_path):
    live = tmp_path / _struct_name("aa" * 12)
    orphan = tmp_path / _struct_name("bb" * 12)
    for p in (live, orphan):
        p.write_bytes(b"x" * 64)
    plan = _write_plan_entry(tmp_path, ["aa" * 12])
    old = time.time() - 90 * 86400
    os.utime(live, (old, old))
    os.utime(orphan, (old, old))
    res = bb.prune_vm_cache(max_age_days=365, max_bytes=0,
                            cache_dir=str(tmp_path))
    assert plan.exists()
    assert live.exists()  # referenced: survives its age
    assert not orphan.exists()
    assert res["evicted"] == 1


def test_prune_drops_structs_when_referencing_plan_goes(tmp_path):
    struct = tmp_path / _struct_name("cc" * 12)
    struct.write_bytes(b"x" * 64)
    plan = _write_plan_entry(tmp_path, ["cc" * 12])
    old = time.time() - 90 * 86400
    os.utime(plan, (old, old))
    res = bb.prune_vm_cache(max_age_days=30, max_bytes=0,
                            cache_dir=str(tmp_path))
    assert not plan.exists() and not struct.exists()
    assert res["evicted"] == 2


def test_fused_key_rides_program_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_CACHE", str(tmp_path))
    bb._program.cache_clear()
    try:
        prog, fold = bb._program("g2_subgroup", 0, 1)
        key = prog.meta.get("fused_key")
        assert key == ("g2_subgroup", 0, 1,
                       bb._program_fingerprint("g2_subgroup"))
        bb._program.cache_clear()
        again, _ = bb._program("g2_subgroup", 0, 1)  # disk hit this time
        assert again is not prog and again.meta.get("fused_key") == key
    finally:
        bb._program.cache_clear()


# -- structural dedup and scan blocks -------------------------------------


def test_structural_dedup_collapses_chunks(monkeypatch):
    prog = _periodic_prog(iters=12)
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_SUPEROP", "2")
    out_i, out_f = _run_both(assembled, arrs, (), monkeypatch)
    _check(prog, ints, out_i, out_f)
    st = vm_compile._FUSED[id(assembled)].struct_stats
    assert st["distinct_structs"] < st["chunks"], st
    assert st["superop_segments"] >= 1, st
    assert vm_compile._COUNTERS["struct_misses"] < st["chunks"] + 1


def test_superop_off_still_identical(monkeypatch):
    prog = _periodic_prog(iters=8)
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog, rows=2)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_SUPEROP", "off")
    out_i, out_f = _run_both(assembled, arrs, (2,), monkeypatch)
    _check(prog, ints, out_i, out_f, rows=2)
    assert vm_compile._FUSED[id(assembled)].struct_stats[
        "superop_segments"] == 0


def test_dedup_off_pins_one_structure_a_chunk(monkeypatch):
    prog = _periodic_prog(iters=8)
    assembled = prog.assemble(**BUCKET)
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_DEDUP", "0")
    out_i, out_f = _run_both(assembled, arrs, (), monkeypatch)
    _check(prog, ints, out_i, out_f)
    st = vm_compile._FUSED[id(assembled)].struct_stats
    assert st["distinct_structs"] == st["chunks"]
    assert st["superop_segments"] == 0


def test_struct_units_shared_across_programs(monkeypatch):
    """Two programs of one canonical form share built units: the second
    warm is all hits, and its outputs served through them stay exact."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    a = _periodic_prog(iters=6).assemble(**BUCKET)
    prog_b = _periodic_prog(iters=6)
    b = prog_b.assemble(**BUCKET)
    vm_compile.warm_fused(a, (), device="cpu")
    misses = vm_compile._COUNTERS["struct_misses"]
    assert misses > 0
    vm_compile.warm_fused(b, (), device="cpu")
    assert vm_compile._COUNTERS["struct_misses"] == misses
    assert vm_compile._COUNTERS["struct_hits"] > 0
    ints, arrs = _rand_inputs(prog_b)
    out_i, out_f = _run_both(b, arrs, (), monkeypatch)
    _check(prog_b, ints, out_i, out_f)


def test_corrupted_struct_entry_falls_back_to_rederive(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_CACHE", str(tmp_path))
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    prog = _periodic_prog(iters=6)
    assembled = _with_key(prog.assemble(**BUCKET))
    refs = sorted(vm_compile.fused_program(assembled).plan["structs"])
    assert refs
    for ref in refs:
        assert os.path.exists(vm_compile._struct_cache_path(ref)), ref
    with open(vm_compile._struct_cache_path(refs[0]), "wb") as fh:
        fh.write(b"not a pickle")
    assert vm_compile._load_plan(assembled) is None
    vm_compile.reset_fused_state()
    fresh = _with_key(prog.assemble(**BUCKET))
    ints, arrs = _rand_inputs(prog)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
    out = vm.execute(fresh, arrs, device="cpu")
    want = vm_analysis.eval_ir(prog, ints[0])
    for name, w in want.items():
        assert fq.limbs_to_int(out[name]) == w
    assert vm_compile._load_plan(fresh) is not None  # re-stored intact


def test_env_knob_hardening_warns_once(monkeypatch, capsys):
    vm_compile._ENV_WARNED.clear()
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "banana")
    assert vm_compile.chunk_steps() == vm_analysis.FUSED_CHUNK_STEPS
    assert vm_compile.chunk_steps() == vm_analysis.FUSED_CHUNK_STEPS
    assert capsys.readouterr().err.count(
        "CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK") == 1
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "-8")
    vm_compile._ENV_WARNED.clear()
    assert vm_compile.chunk_steps() == vm_analysis.FUSED_CHUNK_STEPS
    assert "ignoring invalid" in capsys.readouterr().err
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_DEDUP", "maybe")
    vm_compile._ENV_WARNED.clear()
    assert vm_compile.dedup_enabled() is True
    assert "CONSENSUS_SPECS_TPU_VM_DEDUP" in capsys.readouterr().err
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_SUPEROP", "1")
    vm_compile._ENV_WARNED.clear()
    assert vm_compile.superop_min_run({"sched_steps": 8, "n_mul": 1,
                                       "n_lin": 1}) == 3  # auto
    assert "CONSENSUS_SPECS_TPU_VM_SUPEROP" in capsys.readouterr().err
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "7")
    assert vm_compile.chunk_steps() == 7
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_SUPEROP", "4")
    assert vm_compile.superop_min_run({"sched_steps": 8}) == 4
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_SUPEROP", "off")
    assert vm_compile.superop_min_run({"sched_steps": 8}) == 0
    assert capsys.readouterr().err == ""


def test_background_warm_flips_auto_to_fused(monkeypatch):
    """Under CONSENSUS_SPECS_TPU_VM_WARM_BG=1 an auto call whose winner is
    fused but whose signature is not built is served by the interpreter
    and enqueues a background warm; once it lands auto takes fused."""
    prog = _mixed_prog(depth=2)
    assembled = prog.assemble(**BUCKET)
    _, arrs = _rand_inputs(prog)
    sig = vm_compile.shape_sig((), "cpu")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "6")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_WARM_BG", "1")
    assembled._exec_stats = {"fused_ms_row": 1.0, "interp_ms_row": 5.0}
    assert not vm_compile.use_fused(assembled, shape_sig=sig)
    before = vm_compile._COUNTERS["executions"]
    out_cold = vm.execute(assembled, arrs, device="cpu")
    assert vm_compile._COUNTERS["executions"] == before
    assert vm_compile.bg_warm_drain(timeout=120.0)
    assembled._exec_stats = {"fused_ms_row": 1.0, "interp_ms_row": 5.0}
    assert vm_compile.use_fused(assembled, shape_sig=sig)
    out_warm = vm.execute(assembled, arrs, device="cpu")
    assert vm_compile._COUNTERS["executions"] == before + 1
    for name in out_cold:
        assert np.array_equal(out_cold[name], out_warm[name])


def test_fold_for_is_one_when_fused_is_pinned(monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
    assert bb._fold_for("hard_part", 0) == 1
    assert bb._fold_for("miller_product", 160) == 1
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    assert bb._fold_for("hard_part", 0) == 32
    assert bb._fold_for("miller_product", 160) == 8


def test_capture_tally_is_the_capturing_threads_alone():
    """A launch recorded while this thread captures goes to its tally,
    while another thread's launch meanwhile counts at once: the counters
    stay exact with a background capture beside a serving thread."""
    before = cuda_fq.LAUNCHES
    cuda_fq._THREAD.capture = tally = [0]
    try:
        cuda_fq._count_launch()
        t = threading.Thread(target=cuda_fq._count_launch)
        t.start()
        t.join()
    finally:
        cuda_fq._THREAD.capture = None
    assert tally == [1]
    assert cuda_fq.LAUNCHES == before + 1
    cuda_fq.count_replay(5)
    assert cuda_fq.LAUNCHES == before + 6
    cuda_fq.LAUNCHES = before


# -- on the card ----------------------------------------------------------


@pytest.mark.cuda
def test_fused_on_the_card_equals_the_plain_route(dev, monkeypatch):
    """The fused route on the card (kernel 2 in CUDA graphs) against the
    interpreter on the card and the fused route on the CPU (the plain
    product), on a registry program at 1 and 8 rows; each replay counts
    its graph's launches."""
    prog = vmlib.build_g2_subgroup_check(1)
    assembled = prog.assemble(w_mul=bb.W_MUL, w_lin=bb.W_LIN,
                              pad_steps_to=bb.PAD_STEPS,
                              pad_regs_to=bb._pow2(64))
    for rows in (1, 8):
        ints, arrs = _rand_inputs(prog, rows=rows)
        out_i, out_f = _run_both(assembled, arrs, (rows,), monkeypatch, dev)
        _check(prog, ints, out_i, out_f, rows=rows)
        before = cuda_fq.LAUNCHES
        again = vm.execute(assembled, arrs, batch_shape=(rows,), device=dev)
        assert cuda_fq.LAUNCHES - before == assembled.meta["sched_steps"]
        cpu = vm.execute(assembled, arrs, batch_shape=(rows,), device="cpu")
        for name in out_f:
            assert np.array_equal(again[name], out_f[name])
            assert np.array_equal(cpu[name], out_f[name])
    assert vm_compile._COUNTERS["captures"] > 0
    assert vm_compile._COUNTERS["fallbacks"] == 0


@pytest.mark.cuda
def test_background_warm_on_the_card_keeps_counts_exact(dev, monkeypatch):
    """The warm thread captures on a stream of its own while this thread
    launches kernel 1: its captures launch nothing, this thread's
    launches all count, and auto then replays the warmed graphs."""
    from consensus_specs_tpu_torch.ops import cuda_step

    prog = vmlib.build_g2_subgroup_check(1)
    assembled = prog.assemble(w_mul=bb.W_MUL, w_lin=bb.W_LIN,
                              pad_steps_to=bb.PAD_STEPS,
                              pad_regs_to=bb._pow2(64))
    _, arrs = _rand_inputs(prog, rows=2)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_WARM_BG", "1")
    assembled._exec_stats = {"fused_ms_row": 0.0, "interp_ms_row": 1e9}
    mont0, step0 = cuda_fq.LAUNCHES, cuda_step.LAUNCHES
    # the warm's one eager kernel warm-up, where no capture ran before
    warmup = int(str(vm_compile._canon(dev)) not in vm_compile._KERNELS_WARM)
    outs = [vm.execute(assembled, arrs, batch_shape=(2,), device=dev)
            for _ in range(4)]  # interpreted while the warm captures
    assert vm_compile.bg_warm_drain(timeout=300.0)
    assert cuda_step.LAUNCHES - step0 == 4
    assert cuda_fq.LAUNCHES - mont0 == warmup  # captures launch nothing
    assembled._exec_stats = {"fused_ms_row": 0.0, "interp_ms_row": 1e9}
    fused = vm.execute(assembled, arrs, batch_shape=(2,), device=dev)
    assert cuda_fq.LAUNCHES - mont0 == \
        warmup + assembled.meta["sched_steps"]
    for name in fused:
        assert np.array_equal(fused[name], outs[0][name])
    assert vm_compile._COUNTERS["fallbacks"] == 0


def test_vmexec_smoke_default_set_on_the_cpu(monkeypatch, tmp_path, capsys):
    """ops/vmexec_smoke.py's default programs at one row: fused ==
    interp == the oracle, 0 fallbacks; the environment is restored."""
    from consensus_specs_tpu_torch.ops import vmexec_smoke

    monkeypatch.setenv("VMEXEC_SMOKE_ROWS", "1")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                       str(tmp_path / "flight.jsonl"))
    monkeypatch.delenv("CONSENSUS_SPECS_TPU_FLIGHT", raising=False)
    assert vmexec_smoke.main(device="cpu") == 0
    assert "vmexec-smoke: OK" in capsys.readouterr().out
    assert "CONSENSUS_SPECS_TPU_FLIGHT" not in os.environ
    assert "CONSENSUS_SPECS_TPU_VM_EXEC" not in os.environ
