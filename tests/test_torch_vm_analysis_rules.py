"""The port's vmlint rules (consensus_specs_tpu_torch/ops/vm_analysis.py)
on the CPU: its exact-int oracle ``eval_ir`` against the JAX package's on
random inputs of registry and random programs, and the mirror of
tests/test_vm_analysis.py's non-slow cases on the port's own IR: seeded
assembler bugs (a tampered bound, a capacity overflow, a violated
borrowless-subtract precondition, an unsound input) are errors the gate
fails on, waste is a warning, the select-then-multiply register blowup is
flagged and its chained form is not, the cost report classifies, the
structural planner dedups a ladder, and the analysis rides the port's
obs planes.
"""
import random

import pytest

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.ops import (  # noqa: E402
    vm as jvm, vm_analysis as jva, vmlib as jvmlib,
)
from consensus_specs_tpu_torch.ops import (  # noqa: E402
    fq, vm, vm_analysis, vmlib,
)
from consensus_specs_tpu_torch.utils import bls12_381 as O  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

SHAPE = dict(w_mul=96, w_lin=192, pad_steps_to=256, pad_regs_to=64)
SMALL = dict(w_mul=64, w_lin=64, pad_steps_to=256, pad_regs_to=64)


def _random_progs(rng, n_ops=200):
    progs = (vm.Prog(), jvm.Prog())
    vals = [[p.inp(f"x{i}") for i in range(5)] for p in progs]
    value = rng.randrange(O.P)
    for p, vs in zip(progs, vals):
        vs.append(p.const(value))
    for _ in range(n_ops):
        op = rng.choice("mas")
        i, j = rng.randrange(len(vals[0])), rng.randrange(len(vals[0]))
        for vs in vals:
            a, b = vs[i], vs[j]
            vs.append(a * b if op == "m" else a + b if op == "a" else a - b)
    for p, vs in zip(progs, vals):
        for n, v in enumerate(vs[-3:]):
            p.out(v, f"o{n}")
    return progs


@pytest.mark.parametrize("seed", range(4))
def test_eval_ir_equals_the_jax_oracle_on_random_programs(seed):
    rng = random.Random(100 + seed)
    mine, ref = _random_progs(rng)
    for _ in range(3):
        ins = {n: rng.randrange(O.P) for n in mine.input_names}
        assert vm_analysis.eval_ir(mine, ins) == jva.eval_ir(ref, ins)
    with pytest.raises(ValueError):
        vm_analysis.eval_ir(mine, {n: O.P for n in mine.input_names})


@pytest.mark.parametrize("kind", ["g2_subgroup", "hard_part_frobenius"])
def test_eval_ir_equals_the_jax_oracle_on_registry_programs(kind):
    rng = random.Random(7)
    mine, ref = vmlib.BUILDERS[kind](0, 1), jvmlib.BUILDERS[kind](0, 1)
    ins = {n: rng.randrange(O.P) for n in mine.input_names}
    got = vm_analysis.eval_ir(mine, ins)
    assert got == jva.eval_ir(ref, ins)
    assert set(got) == set(mine.output_names)



def _tiny_prog():
    prog = vm.Prog()
    a, b, c = (prog.inp(n) for n in "abc")
    r = (a * b + c) - a
    prog.out(r * r, "r")
    return prog


def test_tiny_program_rederives_clean():
    r = vm_analysis.analyze_prog(_tiny_prog(), name="tiny")
    assert r["errors"] == 0
    assert r["bounds"]["checked"] > 0
    assert r["bounds"]["max_bound_bits"] <= 420


def test_tampered_tracker_bound_is_detected():
    prog = _tiny_prog()
    alu = next(i for i, op in enumerate(prog.ops) if op.kind == 0)
    prog.ops[alu].bound += 1
    r = vm_analysis.analyze_prog(prog, name="tampered")
    assert any(f["rule"] == "bound-mismatch" for f in r["findings"])
    assert r["errors"] >= 1


def test_seeded_capacity_overflow_is_detected_and_gated():
    prog = _tiny_prog()
    a = prog.inp("loose", bound=1 << 419)
    # an ADD past the 15-limb capacity, as an assembler bug would emit
    prog.ops.append(vm._Op(1, a.idx, a.idx, (1 << 419) * 2))
    r = vm_analysis.analyze_prog(prog, name="seeded")
    assert any(f["rule"] == "bound-overflow" for f in r["findings"])
    failures = vm_analysis.gate(
        [r], {"seeded": vm_analysis.baseline_entry(r)})
    assert any("bound-overflow" in f for f in failures)


def test_sub_precondition_violation_is_detected():
    prog = vm.Prog()
    a = prog.inp("a")
    b = prog.inp("b", bound=1 << 410)  # > MP: illegal subtrahend
    prog.ops.append(vm._Op(2, a.idx, b.idx, fq.P + fq.MP))
    r = vm_analysis.analyze_prog(prog, name="subbug")
    assert any(
        f["rule"] == "sub-subtrahend-overflow" for f in r["findings"])


def test_unsound_input_declaration_is_detected():
    prog = vm.Prog()
    a = prog.inp("a", bound=1 << 100)
    prog.out(a * a, "r")
    r = vm_analysis.analyze_prog(prog, name="tightinput")
    assert any(f["rule"] == "input-bound-unsound" for f in r["findings"])


def test_redundant_compress_and_dead_values_flagged():
    prog = vm.Prog()
    a, b = prog.inp("a"), prog.inp("b")
    assert (a * b).bound  # never reaches an out()
    c = prog.compress(a)  # canonical input: compress reduces nothing
    prog.out(c + b, "r")
    r = vm_analysis.analyze_prog(prog, name="waste")
    assert r["bounds"]["dead_ops"] >= 1
    assert r["bounds"]["redundant_compress"] >= 1
    assert r["errors"] == 0


def _select_then_multiply(n_bits=96):
    """Every bit's multiply precomputed against the loop-invariant f: the
    products are input-ready, scheduled at step ~0 and live until their
    distant ladder level."""
    prog = vm.Prog()
    f = [prog.inp(f"f.{j}") for j in range(12)]
    bits = [prog.inp(f"r.{t}") for t in range(n_bits)]
    pre = [[bits[t] * f[j] for j in range(12)] for t in range(n_bits)]
    acc = f
    for t in range(n_bits):
        acc = vmlib.f12_square(prog, acc)
        acc = [acc[j] + pre[t][j] for j in range(12)]
    for j in range(12):
        prog.out(acc[j], f"c.{j}")
    return prog


def _chained(n_bits=96):
    """Every multiply chained on the accumulator."""
    prog = vm.Prog()
    f = [prog.inp(f"f.{j}") for j in range(12)]
    bits = [prog.inp(f"r.{t}") for t in range(n_bits)]
    acc = f
    for t in range(n_bits):
        acc = vmlib.f12_square(prog, acc)
        m = vmlib.f12_mul(prog, acc, f)
        acc = [acc[j] + (bits[t] * m[j]) for j in range(12)]
    for j in range(12):
        prog.out(acc[j], f"c.{j}")
    return prog


def test_select_then_multiply_hazard_is_flagged():
    bad = vm_analysis.analyze_prog(
        _select_then_multiply(), name="select", **SHAPE)
    good = vm_analysis.analyze_prog(_chained(), name="chained", **SHAPE)
    assert bad["pressure"]["hazard"] is True
    assert any(f["rule"] == "live-range-outliers" for f in bad["findings"])
    assert good["pressure"]["hazard"] is False
    assert good["errors"] == 0
    assert bad["pressure"]["max_live"] > 3 * good["pressure"]["max_live"]
    failures = vm_analysis.gate(
        [bad], {"select": vm_analysis.baseline_entry(bad)})
    assert any("live-range-outliers" in f for f in failures)


def test_cost_report_classifies_and_predicts():
    c = vm_analysis.analyze_prog(vmlib.build_hard_part(1), name="hard",
                                 **SHAPE)["cost"]
    assert c["classification"] == "depth-bound"
    assert c["critical_path"] == c["sched_steps"]
    assert c["mul_utilization"] < 0.10
    assert c["predicted_row_s"] > 0.5
    assert len(c["mul_width_profile"]) == 8


def test_hard_part_variants_recover_depth():
    """The width-for-depth hard parts cut the critical path below half the
    legacy chain's 4,864 steps (frobenius by 2.5x), and at fold 8 the
    frobenius schedule is no longer depth-bound; the fused model predicts
    it cheaper than the interpreter model."""
    frob = vm_analysis.analyze_prog(
        vmlib.build_hard_part_frobenius(1), name="frob", **SHAPE)
    crit = frob["cost"]["critical_path"]
    assert frob["errors"] == 0 and crit * 2.5 <= 4864
    win = vm_analysis.analyze_prog(
        vmlib.build_hard_part_windowed(1), name="win", **SHAPE)
    assert win["errors"] == 0 and win["cost"]["critical_path"] < 0.5 * 4864
    frob8 = vm_analysis.analyze_prog(
        vmlib.build_hard_part_frobenius(8), name="frob8", **SHAPE)
    assert frob8["errors"] == 0
    assert frob8["cost"]["classification"] in ("balanced", "width-bound")
    assert frob8["cost"]["critical_path"] == crit
    assert 0 < frob8["cost"]["predicted_fused_row_s"] \
        < frob8["cost"]["predicted_row_s"]
    assert frob8["cost"]["fused_chunks"] > 0


def test_program_stats_cross_checks_the_ir_analysis():
    prog = _chained(24)
    r = vm_analysis.analyze_prog(prog, name="x", **SHAPE)
    ps = vm_analysis.program_stats(prog.assemble(**SHAPE))
    assert ps["sched_steps"] == r["pressure"]["sched_steps"]
    assert ps["mul_ops"] == r["cost"]["mul_ops"]
    assert ps["lin_ops"] == r["cost"]["add_ops"] + r["cost"]["sub_ops"]
    assert ps["max_reg_occupancy"] <= ps["alloc_regs"]
    # a program without schedule metadata has no stats and no plan
    bare = vm.Program.from_arrays(
        ps["alloc_regs"], prog.assemble(**SHAPE).instr, [], [], [], [], {},
        1)
    assert vm_analysis.program_stats(bare) is None
    with pytest.raises(ValueError):
        vm_analysis.lowering_plan(bare)


def test_detect_period_and_window_selection():
    a, b, c = (7, 0, 0), (2, 1, 0), (1, 0, 1)
    assert vm_analysis.detect_period([a, b] * 40) == 2
    assert vm_analysis.detect_period([a, b, c] * 30 + [a]) == 3
    assert vm_analysis.detect_period([a, b] * 20 + [c] + [a, b] * 20) == 2
    rng = random.Random(5)
    rand = [(rng.randrange(50), rng.randrange(9), rng.randrange(9))
            for _ in range(200)]
    assert vm_analysis.detect_period(rand) is None
    assert vm_analysis.select_window(None, 24) == 24
    assert vm_analysis.select_window(14, 24) == 14
    assert vm_analysis.select_window(6, 24) == 24
    assert vm_analysis.select_window(28, 24) == 28
    assert vm_analysis.select_window(96, 24) == 24


def _ladder_prog(iters=12):
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


def test_structural_plan_dedups_ladder_chunks():
    assembled = _ladder_prog().assemble(**SMALL)
    plan = vm_analysis.lowering_plan(assembled, chunk_steps=3)
    sp = vm_analysis.structural_plan(plan)
    inst = sp["instances"]
    assert len(sp["structs"]) < len(inst)
    for c in inst:
        body = sp["structs"][c["struct"]]
        assert len(c["in_idx"]) == body["n_in"]
        assert len(c["consts"]) == body["n_const"]
        assert len(c["boundary_idx"]) == c["m_out"]
        assert all(0 <= i < c["m_in"] for i in c["in_idx"])
        n_out = len(body["out"])
        assert all(0 <= i < n_out + c["m_in"] for i in c["boundary_idx"])
    sp0 = vm_analysis.structural_plan(plan, dedup=False)
    assert len(sp0["structs"]) == len(sp0["instances"])
    runs = vm_analysis.superop_runs(inst, min_run=2)
    assert runs and max(r for _, r in runs) >= 4


def test_superop_runs_require_shape_invariant_carry():
    inst = [
        {"struct": "A", "m_in": 4, "m_out": 4},
        {"struct": "A", "m_in": 4, "m_out": 4},
        {"struct": "A", "m_in": 4, "m_out": 4},
        {"struct": "B", "m_in": 4, "m_out": 4},
        {"struct": "A", "m_in": 4, "m_out": 6},
        {"struct": "A", "m_in": 6, "m_out": 6},
        {"struct": "A", "m_in": 6, "m_out": 6},
    ]
    assert vm_analysis.superop_runs(inst, min_run=3) == [(0, 3)]
    assert vm_analysis.superop_runs(inst, min_run=2) == [(0, 3), (5, 2)]
    assert vm_analysis.superop_runs([], min_run=2) == []
    # scan blocks: fixed-size blocks per (structure, carry width)
    segs = vm_analysis.scan_blocks(inst, 2)
    assert [s for s in segs if s[0] == "scan"] == [("scan", 0, 2),
                                                   ("scan", 5, 2)]
    assert sum(s[2] if s[0] == "scan" else 1 for s in segs) == len(inst)


def test_structural_stats_report_shape():
    st = vm_analysis.structural_stats(
        _ladder_prog().assemble(**SMALL), chunk_target=4)
    assert st["chunks"] >= st["distinct_structs"] >= 1
    assert st["dedup_ratio"] >= 1.0
    assert st["predicted_cold_s"] <= st["predicted_cold_nodedup_s"]
    r = vm_analysis.analyze_prog(_ladder_prog(), name="ladder")
    entry = vm_analysis.baseline_entry(r)
    assert entry["distinct_structs"] == r["structure"]["distinct_structs"]
    assert entry["dedup_ratio"] == r["structure"]["dedup_ratio"]


def test_gate_detects_pressure_and_depth_regressions():
    r = vm_analysis.analyze_prog(_tiny_prog(), name="p")
    entry = vm_analysis.baseline_entry(r)
    assert vm_analysis.gate([r], {"p": entry}) == []
    tight = dict(entry, max_live=max(1, entry["max_live"] // 2))
    assert any("max_live regressed" in f
               for f in vm_analysis.gate([r], {"p": tight}))
    tight = dict(entry, critical_path=max(1, entry["critical_path"] - 2))
    assert any("critical_path regressed" in f
               for f in vm_analysis.gate([r], {"p": tight}))
    assert any("not in VMLINT_BASELINE" in f
               for f in vm_analysis.gate([r], {}))


def test_prog_analyze_is_analyze_prog():
    assert _tiny_prog().analyze(name="t") == \
        vm_analysis.analyze_prog(_tiny_prog(), name="t")


def test_analysis_exports_to_obs_registry_and_gauges():
    from consensus_specs_tpu_torch.obs import programs as obs_programs
    from consensus_specs_tpu_torch.ops import profiling

    prog = vm.Prog()
    a, b, c = (prog.inp(n) for n in "abc")
    prog.out(((a * b + c) - a) * a, "r")
    r = vm_analysis.analyze_prog(prog, name="tiny[k=0,fold=1]")
    vm_analysis.export_to_obs([r])
    analysis = obs_programs.registry_snapshot()["programs"][
        "tiny[k=0,fold=1]"]["analysis"]
    assert analysis["max_live"] == r["pressure"]["max_live"]
    assert analysis["classification"] == r["cost"]["classification"]
    gauges = profiling.summary()
    assert gauges["vm.analysis_programs"]["gauge"] == 1
    assert gauges["vm.analysis_errors"]["gauge"] == 0
    # analyze then execute: a later note_assembly merges, keeping the
    # analysis beside the assembly stats
    obs_programs.note_assembly("tiny[k=0,fold=1]", n_steps=8, n_regs=16,
                               seconds=0.01, disk_cache_hit=False)
    merged = obs_programs.registry_snapshot()["programs"]["tiny[k=0,fold=1]"]
    assert merged["steps"] == 8
    assert merged["analysis"]["max_live"] == r["pressure"]["max_live"]


def test_fused_route_equals_the_jax_oracle(monkeypatch):
    """The port's fused route (plain products here) on a registry program
    and 2 rows against the JAX package's exact-int oracle."""
    import numpy as np

    from consensus_specs_tpu_torch.ops import vm_compile

    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
    prog = vmlib.build_h2g_finish(1)
    assembled = prog.assemble(**SHAPE)
    rng = random.Random(11)
    ints = [{n: rng.randrange(O.P) for n in prog.input_names}
            for _ in range(2)]
    ins = {n: np.stack([fq.to_mont_int(r[n]) for r in ints])
           for n in prog.input_names}
    try:
        out = vm.execute(assembled, ins, batch_shape=(2,), device="cpu")
        assert vm_compile._COUNTERS["executions"] >= 1
    finally:
        vm_compile.reset_fused_state()
    ref = jvmlib.build_h2g_finish(1)
    for r in range(2):
        for name, w in jva.eval_ir(ref, ints[r]).items():
            assert fq.limbs_to_int(out[name][r]) == w, name
