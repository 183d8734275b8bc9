"""vmlint core: static analysis over field-ALU VM programs (ops/vm.py IR).

The port's copy of consensus_specs_tpu/ops/vm_analysis.py (which imports
only its package's ``fq``), over the port's own ``vm``, ``vmlib``,
``bls_backend`` and ``obs/programs``; every report, plan and structure it
derives equals the JAX package's on the same program
(tests/test_torch_vm_analysis.py).

1. **Bound soundness** (`check_bounds`): a forward interval analysis over
   the op DAG that re-derives every value-magnitude bound from scratch
   (the Montgomery-mul / add / borrowless-sub transfer functions are
   written out here, not called through `Prog`) and cross-checks the
   assembler's recorded bound op by op. A mismatch, a derived bound at or
   past the 15-limb capacity, a violated borrowless-subtract precondition
   or an input declared tighter than a canonical residue is an ERROR;
   compress multiplies that reduce nothing, values that never reach an
   `out()` and unused inputs are warnings.

2. **Liveness / register pressure** (`check_pressure`): per-step live sets
   over the assembled schedule, and the live-range-outlier rule that
   flags input-ready ops scheduled at step ~0 whose values sit live for
   thousands of steps (the select-then-multiply register blowup).

3. **Critical path / cost** (`check_cost`): longest dependency chain,
   per-level width profile, unit mix, a depth-bound / width-bound
   classification and the JAX package's predicted runtimes (its cost
   model's constants, kept so that the reports stay equal; they model
   the JAX package's interpreter and lowering, not the card).

`lowering_plan`, `plan_structures`, `structural_plan` and `scan_blocks`
are the planning artifacts the fused lowering (ops/vm_compile.py) runs;
`eval_ir` is the exact-int oracle of the VM semantics; `run_registry`
analyzes the production registry and `gate` holds the reports to the
committed VMLINT_BASELINE.json (tools/torch_vmlint.py).
"""
import json
import os
from typing import Dict, List, Optional, Tuple

from . import fq

# op kinds, mirroring ops/vm.py (inputs -1, consts -2, ALU 0/1/2)
_MUL, _ADD, _SUB = 0, 1, 2

# 15 x 28-bit limb value capacity, re-derived from the limb layout rather
# than imported from vm.py — the whole point is an independent check
B_CAP = 1 << (fq.LIMB_BITS * fq.NUM_LIMBS)

# the JAX package's cost model of its CPU scan interpreter (its numbers,
# kept so that the reports equal the JAX package's): us per scan step at
# a ~600-register file, scaling with register-file size
COST_US_PER_STEP = 280.0
COST_MODEL_REGS = 600.0

# the JAX package's cost model of its fused straight-line lowering: the
# real ops only (no idle lanes, no register-file traffic) plus per-level
# glue and per-chunk dispatch. The plan's super-op rule (auto_min_run)
# reads it, so the port plans the same chunks and runs as the JAX package.
FUSED_COST_US_PER_MUL = 1.7
FUSED_COST_US_PER_LIN = 0.25
FUSED_COST_US_PER_LEVEL = 30.0
FUSED_COST_US_PER_CHUNK = 250.0
# default level-group size of the fused lowering (the JAX package's);
# CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK overrides
FUSED_CHUNK_STEPS = 24

# live-range outlier rule: an ALU value is "long-lived" when its live range
# exceeds max(LONG_RANGE_MIN_STEPS, LONG_RANGE_FRAC x scheduled steps). The
# program is hazard-flagged when long-lived values OCCUPY the register file:
# their step-occupancy integral (sum of live-range lengths) exceeds
# HAZARD_OCCUPANCY_FRAC of the total occupancy integral (= sum of the
# per-step pressure), with an absolute count floor so a handful of
# legitimately long-lived values never trips it. Measured on the registry:
# healthy programs keep the long-lived share at ~15-30% (loop-invariant
# operands like the RLC ladder's f-1 coefficients and their CSE'd Karatsuba
# half-sums legitimately live the whole program), while the
# select-then-multiply pattern — input-ready ops scheduled at step ~0,
# consumed thousands of steps later — puts it at ~70-90%.
LONG_RANGE_MIN_STEPS = 256
LONG_RANGE_FRAC = 0.5
HAZARD_MIN_BUDGET = 64
HAZARD_OCCUPANCY_FRAC = 0.5


# ---------------------------------------------------------------------------
# pass 1: bound soundness
# ---------------------------------------------------------------------------


def _derive_bound(kind: int, ba: int, bb: int) -> int:
    """Independent transfer functions for the three ALU ops.

    MUL is Montgomery: out = (a*b + m*p) / R with m < R, so
    out < a*b/R + p + 1. ADD is exact. SUB is the borrowless form
    out = a + (MP + 1) + (MASK-form of -b), whose value is a - b + (MP + 1)
    <= a + MP + 1 - (b's minimum 0) — bounded by a + MP."""
    if kind == _MUL:
        return (ba * bb) // fq.R_MONT + fq.P + 1
    if kind == _ADD:
        return ba + bb
    if kind == _SUB:
        return ba + fq.MP
    raise ValueError(kind)


def check_bounds(prog) -> Dict:
    """Forward interval analysis + assembler cross-check + waste rules."""
    ops = prog.ops
    derived: List[Optional[int]] = [None] * len(ops)
    errors: List[Dict] = []
    warnings: List[Dict] = []
    checked = 0
    max_bound = 0
    compress_ops = 0
    redundant_compress: List[int] = []

    def err(idx, rule, detail):
        errors.append({"severity": "error", "rule": rule, "op": idx,
                       "detail": detail})

    # const-1 op indices: a mul against one of these is a compress
    one_idxs = {idx for value, idx in prog.consts.items() if value == 1}

    for i, op in enumerate(ops):
        if op.kind == -1:  # input: the declared bound is the axiom, but a
            # canonical Montgomery residue can be any value < p, so a
            # declaration tighter than p is unsound for every real feed
            if op.bound < fq.P:
                err(i, "input-bound-unsound",
                    f"input declared bound 2^{op.bound.bit_length() - 1} "
                    "< p — canonical Montgomery residues reach p-1")
            if op.bound >= B_CAP:
                err(i, "input-bound-overflow",
                    "declared input bound exceeds the 15-limb capacity")
            derived[i] = op.bound
            continue
        if op.kind == -2:  # const: encoded to Montgomery form mod p
            derived[i] = fq.P
            if op.bound != fq.P:
                err(i, "const-bound-mismatch",
                    f"const tracked at 2^{op.bound.bit_length() - 1}, "
                    "expected p")
            continue
        ba, bb = derived[op.a], derived[op.b]
        if ba is None or bb is None:
            err(i, "dataflow-order",
                "operand defined after its consumer — IR not topological")
            derived[i] = op.bound
            continue
        if op.kind == _SUB:
            # borrowless-subtract preconditions: MP - b must not borrow,
            # and the shifted result must fit the limb capacity
            if bb > fq.MP:
                err(i, "sub-subtrahend-overflow",
                    f"subtrahend bound 2^{bb.bit_length() - 1} exceeds the "
                    "MP shift — borrowless subtract would underflow")
            if ba + fq.MP >= B_CAP:
                err(i, "sub-minuend-overflow",
                    "minuend + MP exceeds the 15-limb capacity")
        d = _derive_bound(op.kind, ba, bb)
        derived[i] = d
        checked += 1
        max_bound = max(max_bound, d)
        if d >= B_CAP:
            err(i, "bound-overflow",
                f"derived bound 2^{d.bit_length() - 1} >= capacity 2^420 — "
                "limb carries can overflow the 15-limb lane")
        if d != op.bound:
            err(i, "bound-mismatch",
                f"assembler tracked 2^{op.bound.bit_length() - 1}, "
                f"analysis derives 2^{d.bit_length() - 1} "
                f"({'assembler UNDER-estimates (unsound)' if op.bound < d else 'assembler over-estimates (formula drift)'})")
        if op.kind == _MUL and (op.a in one_idxs or op.b in one_idxs):
            compress_ops += 1
            src = op.b if op.a in one_idxs else op.a
            in_bound = derived[src]
            if in_bound is not None and d >= in_bound:
                # the multiply achieved no magnitude reduction: a wasted
                # mul-lane slot (compress pays off only past ~2^383)
                redundant_compress.append(i)

    # dead-value sweep: backward reachability from the outputs
    reachable = [False] * len(ops)
    stack = list(prog.outputs)
    for idx in stack:
        reachable[idx] = True
    while stack:
        i = stack.pop()
        op = ops[i]
        if op.kind in (_MUL, _ADD, _SUB):
            for src in (op.a, op.b):
                if not reachable[src]:
                    reachable[src] = True
                    stack.append(src)
    dead_ops = [
        i for i, op in enumerate(ops)
        if op.kind in (_MUL, _ADD, _SUB) and not reachable[i]
    ]
    unused_inputs = [i for i in prog.inputs if not reachable[i]]
    if dead_ops:
        warnings.append({
            "severity": "warn", "rule": "dead-values",
            "detail": f"{len(dead_ops)} ALU ops never reach an out() — "
                      "scheduled work feeding nothing",
        })
    if unused_inputs:
        warnings.append({
            "severity": "warn", "rule": "unused-inputs",
            "detail": f"{len(unused_inputs)} inputs never reach an out()",
        })
    if redundant_compress:
        warnings.append({
            "severity": "warn", "rule": "redundant-compress",
            "detail": f"{len(redundant_compress)} compress multiplies "
                      "achieve no magnitude reduction (input bound already "
                      "compressed-size) — wasted mul-lane slots",
        })
    return {
        "checked": checked,
        "max_bound_bits": max_bound.bit_length(),
        "compress_ops": compress_ops,
        "redundant_compress": len(redundant_compress),
        "dead_ops": len(dead_ops),
        "unused_inputs": len(unused_inputs),
        "errors": errors,
        "warnings": warnings,
    }


# ---------------------------------------------------------------------------
# pass 2: liveness / register pressure (needs the assembled schedule)
# ---------------------------------------------------------------------------


def check_pressure(prog, assembled, keep_per_step: bool = False) -> Dict:
    """Per-step live sets over the schedule `assemble()` annotated onto the
    ops (step / last_use_step), plus the live-range-outlier hazard rule.
    ``keep_per_step`` attaches the full per-step pressure curve (one int
    per scheduled step) instead of only the 8-sample profile."""
    ops = prog.ops
    meta = assembled.meta or {}
    sched_steps = meta.get("sched_steps")
    if sched_steps is None:
        sched_steps = max(
            (op.step for op in ops if op.step >= 0), default=-1) + 1
    # live interval per value: [start, end] inclusive, in schedule steps.
    # inputs/consts are defined before step 0; outputs are read "after the
    # end" (assemble marks them n_steps + 1) — clamp into the step range.
    delta = [0] * (sched_steps + 2)
    n_used_inputs = 0
    long_threshold = max(LONG_RANGE_MIN_STEPS,
                         int(LONG_RANGE_FRAC * sched_steps))
    long_lived = 0
    long_occupancy = 0  # step-occupancy integral of the long-lived values
    ranges = []  # (range_len, idx) for the outlier report
    for i, op in enumerate(ops):
        alu = op.kind in (_MUL, _ADD, _SUB)
        start = op.step if alu else 0
        if start < 0:
            continue  # unscheduled (shouldn't happen post-assemble)
        end = op.last_use_step
        if end < 0:
            end = start  # dead value: freed right after definition
        end = min(end, sched_steps)
        delta[start] += 1
        delta[end + 1] -= 1
        if not alu and op.kind == -1 and op.last_use_step >= 0:
            n_used_inputs += 1
        if alu and (end - start) > long_threshold:
            long_lived += 1
            long_occupancy += end - start + 1
            ranges.append((end - start, i))
    pressure = []
    cur = 0
    for t in range(sched_steps):
        cur += delta[t]
        pressure.append(cur)
    max_live = max(pressure, default=0)
    mean_live = sum(pressure) / len(pressure) if pressure else 0.0
    # compact histogram: live-set size sampled at 8 evenly spaced steps
    profile = []
    if pressure:
        for q in range(8):
            profile.append(pressure[(q * (len(pressure) - 1)) // 7 if len(pressure) > 1 else 0])
    total_occupancy = sum(pressure)
    occupancy_share = (
        long_occupancy / total_occupancy if total_occupancy else 0.0)
    hazard = (long_lived > HAZARD_MIN_BUDGET
              and occupancy_share > HAZARD_OCCUPANCY_FRAC)
    ranges.sort(reverse=True)
    alloc_regs = meta.get("alloc_regs")
    findings = []
    if hazard:
        findings.append({
            "severity": "error", "rule": "live-range-outliers",
            "detail": (
                f"{long_lived} ALU values live > {long_threshold} steps, "
                f"occupying {occupancy_share:.0%} of the register file's "
                f"step-occupancy (healthy programs stay under "
                f"{HAZARD_OCCUPANCY_FRAC:.0%}): input-ready ops scheduled "
                "at step ~0 and consumed far later dominate the file; "
                "chain them on the consumer (the select-then-multiply "
                "register blowup)"),
        })
    out = {
        "sched_steps": sched_steps,
        "max_live": max_live,
        "mean_live": round(mean_live, 1),
        "pressure_profile": profile,
        "alloc_regs": alloc_regs,
        "alloc_efficiency": (
            round(max_live / alloc_regs, 3) if alloc_regs else None),
        "long_range_threshold": long_threshold,
        "long_lived": long_lived,
        "used_inputs": n_used_inputs,
        "long_occupancy_share": round(occupancy_share, 3),
        "hazard": hazard,
        "worst_ranges": [r for r, _ in ranges[:5]],
        "findings": findings,
    }
    if keep_per_step:
        out["per_step"] = pressure
    return out


# ---------------------------------------------------------------------------
# pass 3: critical path / unit mix / cost model
# ---------------------------------------------------------------------------


def check_cost(prog, assembled, w_mul: int, w_lin: int) -> Dict:
    """Longest dependency chain, per-level width profile, unit mix, and the
    measured-cost-model runtime prediction + depth/width classification."""
    ops = prog.ops
    level = [0] * len(ops)
    n_mul = n_add = n_sub = 0
    critical = 0
    for i, op in enumerate(ops):
        if op.kind == _MUL:
            n_mul += 1
        elif op.kind == _ADD:
            n_add += 1
        elif op.kind == _SUB:
            n_sub += 1
        else:
            continue
        level[i] = 1 + max(level[op.a], level[op.b])
        critical = max(critical, level[i])
    n_lin = n_add + n_sub
    work_steps = max(-(-n_mul // w_mul) if n_mul else 0,
                     -(-n_lin // w_lin) if n_lin else 0)
    meta = assembled.meta or {}
    sched_steps = meta.get("sched_steps", assembled.n_steps)
    if critical >= 2 * work_steps:
        classification = "depth-bound"
    elif work_steps >= 2 * critical:
        classification = "width-bound"
    else:
        classification = "balanced"
    # per-level width profile: mul ops per dependency level, summarized at
    # 8 evenly spaced levels (the shape the width-for-depth rewrites read)
    width_at_level = [0] * (critical + 1)
    for i, op in enumerate(ops):
        if op.kind == _MUL:
            width_at_level[level[i]] += 1
    profile = []
    if critical:
        for q in range(8):
            profile.append(width_at_level[1 + (q * (critical - 1)) // 7 if critical > 1 else 1])
    predicted_row_s = (
        assembled.n_steps * COST_US_PER_STEP * 1e-6
        * (assembled.n_regs / COST_MODEL_REGS))
    # fused-path prediction: the straight-line lowering pays the
    # real per-level widths (sum over levels of mul/lin counts = n_mul /
    # n_lin) plus per-level glue and per-chunk dispatch — never the idle
    # lanes or the register-file traffic the interpreter model is built on
    n_chunks = -(-sched_steps // FUSED_CHUNK_STEPS) if sched_steps else 0
    predicted_fused_row_s = (
        n_mul * FUSED_COST_US_PER_MUL
        + n_lin * FUSED_COST_US_PER_LIN
        + sched_steps * FUSED_COST_US_PER_LEVEL
        + n_chunks * FUSED_COST_US_PER_CHUNK) * 1e-6
    return {
        "mul_ops": n_mul,
        "add_ops": n_add,
        "sub_ops": n_sub,
        "critical_path": critical,
        "work_steps": work_steps,
        "sched_steps": sched_steps,
        "padded_steps": assembled.n_steps,
        "classification": classification,
        "mul_utilization": (
            round(n_mul / (sched_steps * w_mul), 4) if sched_steps else 0.0),
        "lin_utilization": (
            round(n_lin / (sched_steps * w_lin), 4) if sched_steps else 0.0),
        "schedule_efficiency": (
            round(max(critical, work_steps) / sched_steps, 3)
            if sched_steps else None),
        "mul_width_profile": profile,
        "predicted_row_s": round(predicted_row_s, 4),
        "fused_chunks": n_chunks,
        "predicted_fused_row_s": round(predicted_fused_row_s, 4),
    }


# ---------------------------------------------------------------------------
# assembled-program stats (no IR needed — e.g. a .vm_cache pickle)
# ---------------------------------------------------------------------------


def program_stats(assembled) -> Optional[Dict]:
    """Schedule stats recomputed from the instruction TENSORS of an
    assembled Program (meta + per-step destination scan): per-unit fill and
    the register-occupancy curve. Works on cache-loaded programs whose IR
    is gone; returns None for pre-meta pickles."""
    import numpy as np

    meta = assembled.meta
    if not meta:
        return None
    msa, msb, msd, lsa, lsb, lsub, lsd = assembled.instr
    sched = meta["sched_steps"]
    trash_mul, trash_lin = meta["trash_mul"], meta["trash_lin"]
    mul_fill = (msd[:sched] < trash_mul).sum(axis=1)
    lin_fill = (lsd[:sched] < trash_lin).sum(axis=1)
    # register occupancy: a register is in use from its first write (or
    # step 0 for inputs/consts) through its last read
    n_regs = meta["alloc_regs"]
    first_def = np.full(n_regs, -2, dtype=np.int64)
    last_read = np.full(n_regs, -2, dtype=np.int64)
    preloaded = set(int(r) for r in assembled.input_regs)
    preloaded.update(assembled.const_regs)
    for t in range(sched):
        for arr in (msa[t], msb[t], lsa[t], lsb[t]):
            regs = arr[arr < n_regs]
            last_read[regs] = t
        for arr in (msd[t], lsd[t]):
            regs = arr[(arr >= 0) & (arr < n_regs)]
            fresh = regs[first_def[regs] == -2]
            first_def[fresh] = t
    for r in preloaded:
        if r < n_regs:
            first_def[r] = -1
    for r in assembled.output_regs:
        if r < n_regs:
            last_read[int(r)] = sched
    delta = np.zeros(sched + 2, dtype=np.int64)
    used = (first_def > -2) & (last_read > -2)
    starts = np.clip(first_def[used], 0, sched)
    ends = np.clip(last_read[used], 0, sched)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends + 1, -1)
    occupancy = np.cumsum(delta)[:sched]
    return {
        "sched_steps": int(sched),
        "mul_ops": int(mul_fill.sum()),
        "lin_ops": int(lin_fill.sum()),
        "mul_fill_max": int(mul_fill.max()) if sched else 0,
        "lin_fill_max": int(lin_fill.max()) if sched else 0,
        "max_reg_occupancy": int(occupancy.max()) if sched else 0,
        "alloc_regs": int(n_regs),
    }


# ---------------------------------------------------------------------------
# compiler-backend API: the artifacts the fused straight-line
# lowering (ops/vm_compile.py) consumes — derived from the instruction
# TENSORS, so cache-loaded programs whose IR is gone lower fine too
# ---------------------------------------------------------------------------


def lowering_plan(assembled, chunk_steps: int = None,
                  boundaries: List[int] = None) -> Dict:
    """Per-level op lists + chunk-boundary live sets for the fused lowering.

    For every scheduled level, the REAL (non-idle) lanes of each unit as
    ``(a_regs, b_regs, dst_regs)`` columns (lin split into add/sub — the
    is_sub flag becomes a static branch, not a runtime select), and every
    ``chunk_steps`` levels — or at each EXPLICIT ``boundaries`` start
    (the period-resynced chunking of ``periodic_boundaries``) — an EXACT
    live-in register set from a backward liveness pass over the schedule
    — the carry each traced level-group function receives from the
    previous one.

    Constant registers and the always-zero scratch register are excluded
    from live sets while their PRELOADED value is the live one (the
    lowering inlines constants as literals); a const register re-allocated
    to an ALU value rejoins the carry from its redefinition onward.

    Raises ``ValueError`` on pre-meta programs (old ``.vm_cache`` pickles
    carry no schedule metadata) — callers fall back to the interpreter.
    """
    import numpy as np

    if chunk_steps is None:
        chunk_steps = FUSED_CHUNK_STEPS
    chunk_steps = max(1, int(chunk_steps))
    meta = assembled.meta
    if not meta or "sched_steps" not in meta:
        raise ValueError(
            "program has no schedule metadata (pre-meta .vm_cache pickle) "
            "— the fused lowering needs an assemble()-produced Program")
    sched = int(meta["sched_steps"])
    trash_mul, trash_lin = meta["trash_mul"], meta["trash_lin"]
    msa, msb, msd, lsa, lsb, lsub, lsd = assembled.instr
    const_regs = set(int(r) for r in assembled.const_regs)
    out_regs = [int(r) for r in assembled.output_regs]

    levels = []
    n_mul = n_lin = 0
    # first step at which each const register is redefined by an ALU op
    # (register reuse): before that step its live value is the inlineable
    # constant, from it onward the register carries a real value
    const_redef: Dict[int, int] = {}
    for t in range(sched):
        mm = msd[t] < trash_mul
        mul = (msa[t][mm].tolist(), msb[t][mm].tolist(),
               msd[t][mm].tolist())
        ll = lsd[t] < trash_lin
        la, lb, ld, ls = lsa[t][ll], lsb[t][ll], lsd[t][ll], lsub[t][ll]
        add = (la[~ls].tolist(), lb[~ls].tolist(), ld[~ls].tolist())
        sub = (la[ls].tolist(), lb[ls].tolist(), ld[ls].tolist())
        n_mul += len(mul[2])
        n_lin += len(add[2]) + len(sub[2])
        for d in mul[2] + add[2] + sub[2]:
            if d in const_regs and d not in const_redef:
                const_redef[d] = t
        levels.append({"mul": mul, "add": add, "sub": sub})

    def _carryable(reg: int, boundary: int) -> bool:
        """Whether ``reg``'s live value at ``boundary`` must ride the
        carry: yes unless it is the scratch zero or a still-preloaded
        constant (both inlined by the lowering)."""
        if reg == 0:
            return False
        if reg in const_regs:
            return const_redef.get(reg, sched) < boundary
        return True

    if boundaries is not None:
        starts = sorted(set(int(s) for s in boundaries if 0 <= s < sched))
        if not starts or starts[0] != 0:
            starts = [0] + [s for s in starts if s != 0]
    else:
        starts = list(range(0, sched, chunk_steps))
    start_index = {s: i for i, s in enumerate(starts)}
    live = set(out_regs)
    live_in: List[List[int]] = [[] for _ in starts]
    for t in range(sched - 1, -1, -1):
        lv = levels[t]
        for unit in ("mul", "add", "sub"):
            live.difference_update(lv[unit][2])
        for unit in ("mul", "add", "sub"):
            live.update(lv[unit][0])
            live.update(lv[unit][1])
        ci = start_index.get(t)
        if ci is not None:
            live_in[ci] = sorted(r for r in live if _carryable(r, t))
    chunks = [
        {"start": s,
         "stop": starts[i + 1] if i + 1 < len(starts) else sched,
         "live_in": live_in[i]}
        for i, s in enumerate(starts)
    ]
    return {
        "sched_steps": sched,
        "chunk_steps": chunk_steps,
        "levels": levels,
        "chunks": chunks,
        "inputs": [int(r) for r in assembled.input_regs],
        "outputs": out_regs,
        "consts": {int(r): v for r, v in assembled.const_regs.items()},
        "n_mul": n_mul,
        "n_lin": n_lin,
    }


# ---------------------------------------------------------------------------
# structural canonicalization: the dedup artifacts the fused
# backend builds ONCE per distinct chunk shape — a square-and-multiply
# ladder is a handful of level-chunk structures stamped out hundreds of
# times, so canonicalizing each chunk up to constant values and live-set
# permutation makes the cold bill one unit per structure, not per chunk
# ---------------------------------------------------------------------------

# the JAX package's model of its lowering's compile cost, per scheduled
# level and per compile unit: plan_structures picks the boundary mode
# that predicts the cheaper cold start under it, so the port keeps the
# constants to plan the same chunks (on the card a unit is a CUDA graph
# capture, not an XLA compile; phase `vmexec` of chip_smoke.py measures)
FUSED_COMPILE_S_PER_LEVEL = 0.4
FUSED_COMPILE_S_PER_UNIT = 2.0

# period detection bounds: the level-signature autocorrelation scan looks
# for the smallest period whose pairwise match fraction clears MIN_MATCH
# (boundary chunks and sparse set-bit interruptions keep it under 1.0 —
# g2_subgroup measures 0.97 at period 14, g1_subgroup 0.9+ at 6)
PERIOD_MAX = 96
PERIOD_MIN_MATCH = 0.85


def level_signatures(plan: Dict) -> List[Tuple[int, int, int]]:
    """Cheap per-level shape signature of a lowering plan: (mul, add, sub)
    real-lane counts — the autocorrelation key ``detect_period`` scans."""
    return [
        (len(lv["mul"][2]), len(lv["add"][2]), len(lv["sub"][2]))
        for lv in plan["levels"]
    ]


def detect_period(sigs: List, max_period: int = PERIOD_MAX,
                  min_match: float = PERIOD_MIN_MATCH) -> Optional[int]:
    """Smallest p such that ``sigs[i] == sigs[i+p]`` for at least
    ``min_match`` of all comparable i — the ladder period of a
    square-and-multiply schedule (None for aperiodic programs like the
    hard part's dense addition chain, where structural dedup degrades
    gracefully to exact-window matching)."""
    n = len(sigs)
    for p in range(1, min(max_period, n // 2) + 1):
        matches = 0
        for i in range(n - p):
            if sigs[i] == sigs[i + p]:
                matches += 1
        if n - p and matches / (n - p) >= min_match:
            return p
    return None


def periodic_boundaries(sigs: List, period: int,
                        target: int) -> Optional[List[int]]:
    """Chunk starts RE-SYNCED to the ladder period at irregularities.

    Uniform windows keep one phase only until the first irregular row
    (a set-bit product, the prologue) shifts it — after which every
    steady window lands on a different phase and canonicalizes to a
    fresh structure. Here steady chunks are single-period windows
    anchored to ONE reference pattern (the first self-repeating period
    of the signature stream), and the irregular levels between steady
    regions become their own short chunks (capped at ``target``
    levels): every steady chunk across ALL regions shares a phase, so
    a sparse-exponent ladder collapses to one steady structure plus a
    handful of short irregular ones. Returns None when no reference
    period exists (the caller keeps uniform windows)."""
    n = len(sigs)
    ref = None
    for i in range(n - 2 * period + 1):
        if all(sigs[i + j] == sigs[i + period + j] for j in range(period)):
            ref = sigs[i:i + period]
            break
    if ref is None:
        return None

    def anchored(i: int) -> bool:
        return (i + period <= n
                and all(sigs[i + j] == ref[j] for j in range(period)))

    starts = []
    i = 0
    while i < n:
        starts.append(i)
        if anchored(i):
            i += period
            continue
        j = i + 1
        while j < n and (j - i) < target and not anchored(j):
            j += 1
        i = j
    return starts


def scan_blocks(instances: List[Dict], min_run: int) -> List[tuple]:
    """Executor segmentation shared with the cold-cost model:
    ``("step", ci)`` / ``("scan", ci, length)`` entries covering every
    instance in order. Qualifying runs decompose into FIXED-SIZE scan
    blocks per (structure, carry width) — the pow2 floor of that
    structure's shortest run, clamped [2, 32] — so ONE compiled scan
    executable serves every run of the structure regardless of run
    length; remainder instances ride the structure's step unit."""
    segments: List[tuple] = []
    n = len(instances)
    if not min_run:
        return [("step", ci) for ci in range(n)]
    runs = superop_runs(instances, min_run)
    block: Dict[tuple, int] = {}
    for s, r in runs:
        key = (instances[s]["struct"], instances[s]["m_in"])
        block[key] = min(block.get(key, 1 << 30), r)
    for key, shortest in block.items():
        b = 2
        while b * 2 <= min(shortest, 32):
            b *= 2
        block[key] = b
    run_at = dict(runs)
    ci = 0
    while ci < n:
        r = run_at.get(ci)
        if r:
            b = block[(instances[ci]["struct"], instances[ci]["m_in"])]
            end = ci + r
            while ci + b <= end:
                segments.append(("scan", ci, b))
                ci += b
            while ci < end:
                segments.append(("step", ci))
                ci += 1
        else:
            segments.append(("step", ci))
            ci += 1
    return segments


def predicted_cold_cost(instances: List[Dict],
                        segments: List[tuple]) -> Tuple[int, int, float]:
    """(compile units, levels to compile, predicted seconds) for one
    segmented structural plan — the executor compiles one unit per
    distinct (mode, structure, shapes) key, so the prediction walks the
    same key space."""
    seen = set()
    units = 1  # the entry widen
    levels = 0
    for seg in segments:
        c = instances[seg[1]]
        if seg[0] == "step":
            key = ("step", c["struct"], c["m_in"], c["m_out"])
        else:
            key = ("scan", c["struct"], c["m_in"], seg[2])
        if key in seen:
            continue
        seen.add(key)
        units += 1
        levels += c["stop"] - c["start"]
    seconds = round(levels * FUSED_COMPILE_S_PER_LEVEL
                    + units * FUSED_COMPILE_S_PER_UNIT, 1)
    return units, levels, seconds


def auto_min_run(plan: Dict) -> int:
    """The super-op auto rule: fold runs (min length 3) when the
    per-level dispatch glue outweighs the real per-level ALU work under
    the FUSED_COST_* model (the JAX package's) — the fold-1 ladder
    regime, where its per-level launch overhead dominates."""
    sched = max(1, int(plan.get("sched_steps", 1)))
    work_us = (plan.get("n_mul", 0) * FUSED_COST_US_PER_MUL
               + plan.get("n_lin", 0) * FUSED_COST_US_PER_LIN)
    glue_us = sched * FUSED_COST_US_PER_LEVEL
    return 3 if glue_us >= work_us else 0


def plan_structures(assembled, chunk_target: int, dedup: bool = True,
                    min_run: Optional[int] = None):
    """The structural planning pipeline shared by the fused executor
    (ops/vm_compile.py) and vmlint: derive the level columns, detect
    the ladder period, build BOTH boundary candidates — the uniform
    period-aligned window and the period-RESYNCED boundaries — and keep
    whichever predicts the lower cold-compile cost under the measured
    model (irregular regions dedup differently per program: resync wins
    sparse-exponent ladders, uniform wins schedules whose gaps don't
    repeat). ``min_run`` None = the ``auto_min_run`` cost-model rule.

    Returns ``(plan_src, sp, info)``: the lowering plan whose chunking
    won, its structural split, and
    ``{"window", "period", "resync", "min_run", "units", "levels",
    "predicted_cold_s"}``."""
    plan_src = lowering_plan(assembled, chunk_steps=chunk_target)
    if min_run is None:
        min_run = auto_min_run(plan_src)
    if not dedup:
        sp = structural_plan(plan_src, dedup=False)
        segs = [("step", ci) for ci in range(len(sp["instances"]))]
        units, levels, cold = predicted_cold_cost(sp["instances"], segs)
        return plan_src, sp, {
            "window": chunk_target, "period": None, "resync": False,
            "min_run": 0, "units": units, "levels": levels,
            "predicted_cold_s": cold,
        }
    sigs = level_signatures(plan_src)
    period = detect_period(sigs)
    window = select_window(period, chunk_target)
    plan_w = (plan_src if window == chunk_target
              else lowering_plan(assembled, chunk_steps=window))
    candidates = [(plan_w, structural_plan(plan_w), False)]
    if period:
        starts = periodic_boundaries(sigs, period, chunk_target)
        if starts:
            plan_r = lowering_plan(assembled, boundaries=starts)
            candidates.append((plan_r, structural_plan(plan_r), True))
    best = None
    for plan_c, sp_c, resync in candidates:
        segs = scan_blocks(sp_c["instances"], min_run)
        units, levels, cold = predicted_cold_cost(sp_c["instances"], segs)
        if best is None or cold < best[2]["predicted_cold_s"]:
            best = (plan_c, sp_c, {
                "window": window, "period": period, "resync": resync,
                "min_run": min_run, "units": units, "levels": levels,
                "predicted_cold_s": cold,
            })
    return best


def select_window(period: Optional[int], target: int) -> int:
    """Chunk window for the fused lowering: the largest multiple of the
    detected ladder period NOT ABOVE ``target`` (so every steady-state
    window lands on the same phase and canonicalizes to ONE structure),
    or the period itself when it exceeds the target — clamped within 2x
    of the configured target so an explicit
    CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK override keeps its meaning.
    Floor rather than nearest on purpose: a smaller period-aligned
    window compiles proportionally fewer levels per distinct structure
    (the JAX package measured that choice on its own lowering).
    Aperiodic programs keep the target unchanged."""
    if not period:
        return target
    w = period * max(1, target // period)
    if w > 2 * target or 2 * w < target:
        return target
    return w


def structural_plan(plan: Dict, dedup: bool = True) -> Dict:
    """Canonicalize every chunk of a lowering plan up to constant values
    and live-set permutation.

    Each chunk's body is renamed into a canonical SSA form: live-in
    registers become input slots numbered by first use, constant
    registers still holding their preload become const slots (their
    VALUES move to per-instance operand tables — two ladder iterations
    with different bit constants share one structure), the always-zero
    scratch register stays a literal, and defs number off in schedule
    order. The chunk's live-out defs (canonical ``out`` list) plus the
    canonical level ops hash into the structure key; everything
    instance-specific — which carry position feeds which input slot, the
    constant values, and how the next boundary's carry assembles from
    [body outputs ++ incoming carry] — lands in per-instance
    ``in_idx`` / ``consts`` / ``boundary_idx`` tables the executor feeds
    as RUNTIME operands, so the backend builds one unit per distinct
    structure and replays it everywhere the canonical form matches (across chunks,
    programs, and — via the plan being shape-free — batch shapes).

    The INTER-chunk carry is width-NORMALIZED: every boundary layout
    pads (with dead slots, never read) to the program's widest live
    boundary, so chunks whose structures match also share their compile
    shapes — without this, a program that steadily consumes its inputs
    (the RLC combine eating its f coefficients) drifts the carry width
    every chunk and fragments otherwise-identical structures into
    per-shape units. The entry (the program's input stack) and
    the exit (the output layout) keep their exact widths.

    Returns ``{"structs": {key: body}, "instances": [...]}`` where body =
    ``{"levels", "out", "n_in", "n_const"}`` and each instance =
    ``{"struct", "in_idx", "consts", "boundary_idx", "m_in", "m_out",
    "start", "stop"}``. ``dedup=False`` salts every key with its chunk
    index — the one-compile-per-chunk baseline the cold benchmark
    races against."""
    import hashlib

    levels = plan["levels"]
    chunks = plan["chunks"]
    consts = plan["consts"]
    structs: Dict[str, Dict] = {}
    instances: List[Dict] = []
    n_ch = len(chunks)
    # normalized inter-chunk carry width (entry and exit stay exact)
    m_norm = max(
        (len(c["live_in"]) for c in chunks[1:]), default=0)
    for ci, ch in enumerate(chunks):
        s, e = ch["start"], ch["stop"]
        in_layout = plan["inputs"] if ci == 0 else ch["live_in"]
        m_in = len(in_layout) if ci == 0 else m_norm
        out_layout = (chunks[ci + 1]["live_in"] if ci + 1 < n_ch
                      else plan["outputs"])
        m_out = m_norm if ci + 1 < n_ch else len(out_layout)
        pos_in: Dict[int, int] = {}
        for i, r in enumerate(in_layout):
            pos_in.setdefault(r, i)
        env: Dict[int, Tuple[str, int]] = {}
        in_refs: List[int] = []  # canonical input slot -> source register
        const_vals: List[int] = []
        defs: List[int] = []  # canonical def id -> destination register
        canon_levels = []

        def resolve(r: int) -> Tuple[str, int]:
            if r == 0:
                return ("z", 0)
            v = env.get(r)
            if v is None:
                # carry beats const: a const register redefined in an
                # EARLIER chunk rides the carry (live_in lists it), only
                # a still-preloaded const becomes a const operand slot
                if r in pos_in:
                    v = ("i", len(in_refs))
                    in_refs.append(r)
                elif r in consts:
                    v = ("c", len(const_vals))
                    const_vals.append(consts[r])
                else:
                    raise KeyError(
                        f"structural_plan: register {r} has no value at "
                        f"chunk {ci} (lowering-plan liveness bug)")
                env[r] = v
            return v

        for t in range(s, e):
            lv = levels[t]
            row = []
            new: Dict[int, Tuple[str, int]] = {}
            for unit in ("mul", "add", "sub"):
                aa, bb, dd = lv[unit]
                row.append([[resolve(a), resolve(b)]
                            for a, b in zip(aa, bb)])
                for d in dd:
                    new[d] = ("d", len(defs))
                    defs.append(d)
            # defs become visible at the NEXT level only (the interpreter
            # reads the pre-step register file)
            env.update(new)
            canon_levels.append(row)

        out_set = set(out_layout)
        out_ids = [i for i, r in enumerate(defs)
                   if env.get(r) == ("d", i) and r in out_set]
        raw = json.dumps(
            [canon_levels, out_ids, len(in_refs), len(const_vals)],
            separators=(",", ":"))
        if not dedup:
            raw = f"{ci}|{raw}"
        key = hashlib.sha256(raw.encode()).hexdigest()[:24]
        if key not in structs:
            structs[key] = {
                "levels": canon_levels,
                "out": out_ids,
                "n_in": len(in_refs),
                "n_const": len(const_vals),
            }
        def_slot = {d: j for j, d in enumerate(out_ids)}
        n_out = len(out_ids)
        boundary_idx = []
        for r in out_layout:
            v = env.get(r)
            if v is not None and v[0] == "d":
                boundary_idx.append(def_slot[v[1]])
            else:
                # pass-through: the value rides the incoming carry,
                # appended after the body outputs in the merge gather
                boundary_idx.append(n_out + pos_in[r])
        while len(boundary_idx) < m_out:
            boundary_idx.append(0)  # dead pad slot: never read
        instances.append({
            "struct": key,
            "in_idx": [pos_in[r] for r in in_refs],
            "consts": const_vals,
            "boundary_idx": boundary_idx,
            "m_in": m_in,
            "m_out": m_out,
            "start": s,
            "stop": e,
        })
    return {"structs": structs, "instances": instances}


def superop_runs(instances: List[Dict],
                 min_run: int = 3) -> List[Tuple[int, int]]:
    """Maximal runs of consecutive instances foldable into ONE scan
    super-op: same structure and a shape-invariant carry (``m_in ==
    m_out`` throughout, so the lax.scan carry keeps one shape while the
    per-instance operand tables ride the scan axis). Returns
    ``[(first_instance_index, run_length), ...]`` for runs of at least
    ``min_run``."""
    runs = []
    i = 0
    n = len(instances)
    while i < n:
        a = instances[i]
        j = i
        if a["m_in"] == a["m_out"]:
            while (j + 1 < n
                   and instances[j + 1]["struct"] == a["struct"]
                   and instances[j + 1]["m_in"] == a["m_in"]
                   and instances[j + 1]["m_out"] == a["m_out"]):
                j += 1
        if j - i + 1 >= max(2, min_run):
            runs.append((i, j - i + 1))
        i = j + 1
    return runs


def structural_stats(assembled, chunk_target: int = None) -> Dict:
    """The vmlint-facing dedup summary for one assembled program:
    detected period, chosen window/boundary mode, chunk count vs
    distinct structural chunk shapes, the dedup ratio, how many chunks
    fold into scan super-op runs, and the predicted cold
    bill with and without dedup — the exact planning pipeline the fused
    executor runs (``plan_structures``), so the committed numbers ARE
    the backend's decisions."""
    if chunk_target is None:
        chunk_target = FUSED_CHUNK_STEPS
    plan, sp, info = plan_structures(assembled, chunk_target)
    instances = sp["instances"]
    n_chunks = len(instances)
    distinct = len(sp["structs"])
    run_chunks = sum(
        r for _, r in superop_runs(instances, max(2, info["min_run"]))
    ) if info["min_run"] else 0
    total_levels = plan["sched_steps"]
    nodedup_chunks = -(-total_levels // chunk_target) if total_levels else 0
    return {
        "period": info["period"],
        "window": info["window"],
        "resync": info["resync"],
        "chunks": n_chunks,
        "distinct_structs": distinct,
        "dedup_ratio": round(n_chunks / distinct, 2) if distinct else 1.0,
        "superop_run_chunks": run_chunks,
        "compile_units": info["units"],
        "compile_levels": info["levels"],
        "predicted_cold_s": info["predicted_cold_s"],
        "predicted_cold_nodedup_s": round(
            total_levels * FUSED_COMPILE_S_PER_LEVEL
            + (nodedup_chunks + 1) * FUSED_COMPILE_S_PER_UNIT, 1),
    }


_N_PRIME = None  # -p^-1 mod R, computed lazily for eval_ir


def eval_ir(prog, inputs: Dict[str, int]) -> Dict[str, int]:
    """Exact-int oracle of the VM semantics over the IR: every value as
    the exact (loose, Montgomery-domain) INTEGER the device computes —
    mul is the Montgomery reduction ``(t + M*p) / R`` with
    ``M = (t * -p^-1) mod R``, add is exact, sub is the borrowless
    ``a + MP - b`` form. ``inputs`` are field integers (< p), encoded to
    the Montgomery domain here exactly like ``fq.to_mont_int``.

    The vmexec smoke and phase ``vmexec`` of chip_smoke.py hold both
    execution routes (the interpreter and the fused lowering) to these
    integers with full limb identity, stronger than mod-p agreement."""
    global _N_PRIME
    if _N_PRIME is None:
        _N_PRIME = (-pow(fq.P, -1, fq.R_MONT)) % fq.R_MONT
    name_of = dict(zip(prog.inputs, prog.input_names))
    vals: List[int] = [0] * len(prog.ops)
    for i, op in enumerate(prog.ops):
        if op.kind == -1:
            x = inputs[name_of[i]]
            if not 0 <= x < fq.P:
                raise ValueError(f"input {name_of[i]!r} not a field int")
            vals[i] = (x * fq.R_MONT) % fq.P
        elif op.kind == -2:
            vals[i] = (op.a * fq.R_MONT) % fq.P
        elif op.kind == _MUL:
            t = vals[op.a] * vals[op.b]
            m = (t * _N_PRIME) % fq.R_MONT
            vals[i] = (t + m * fq.P) // fq.R_MONT
        elif op.kind == _ADD:
            vals[i] = vals[op.a] + vals[op.b]
        elif op.kind == _SUB:
            vals[i] = vals[op.a] + fq.MP - vals[op.b]
        else:
            raise ValueError(f"unknown op kind {op.kind}")
    return {
        name: vals[idx]
        for name, idx in zip(prog.output_names, prog.outputs)
    }


# ---------------------------------------------------------------------------
# the full report
# ---------------------------------------------------------------------------


def analyze_prog(prog, name: str = "<prog>", w_mul: int = 128,
                 w_lin: int = 128, pad_steps_to: int = 1,
                 pad_regs_to: int = 1, keep_per_step: bool = False) -> Dict:
    """Assemble ``prog`` at the given shape and run all three passes.
    Assembly annotates the ops with step/reg/last-use in place, so the
    pressure pass reads the REAL schedule the device would run."""
    assembled = prog.assemble(
        w_mul=w_mul, w_lin=w_lin,
        pad_steps_to=pad_steps_to, pad_regs_to=pad_regs_to)
    bounds = check_bounds(prog)
    pressure = check_pressure(prog, assembled, keep_per_step=keep_per_step)
    cost = check_cost(prog, assembled, w_mul, w_lin)
    structure = structural_stats(assembled)
    findings = (bounds.pop("errors") + bounds.pop("warnings")
                + pressure.pop("findings"))
    return {
        "name": name,
        "ops": {
            "total": len(prog.ops),
            "inputs": len(prog.inputs),
            "consts": len(prog.consts),
            "outputs": len(prog.outputs),
        },
        "bounds": bounds,
        "pressure": pressure,
        "cost": cost,
        "structure": structure,
        "findings": findings,
        "errors": sum(1 for f in findings if f["severity"] == "error"),
        "warnings": sum(1 for f in findings if f["severity"] == "warn"),
    }


# ---------------------------------------------------------------------------
# the program registry (mirrors the production shapes in ops/bls_backend)
# ---------------------------------------------------------------------------


def registry_programs(tier1_only: bool = False) -> List[Tuple[str, str, int, int]]:
    """(key, kind, k, fold) for every program vmlint analyzes, named
    exactly like the obs/programs registry keys so analysis stats merge
    onto the execution registry. The tier-1 subset keeps to small shapes
    (fold <= 2, minimal K) so the pytest gate stays cheap; the full set
    covers the production folds including the chunk-16 rlc_combine and
    the folded hard part."""
    small = [
        ("miller_product", 1, 1),
        ("aggregate_verify", 2, 1),
        ("rlc_combine", 2, 1),
        ("hard_part", 0, 1),
        # the width-for-depth hard-part variants: the tier-1 gate
        # pins their recovered critical path (frobenius 1840 vs the legacy
        # 4740) so a formula edit cannot silently grow the depth back
        ("hard_part_windowed", 0, 1),
        ("hard_part_frobenius", 0, 1),
        ("g1_subgroup", 0, 1),
        ("g2_subgroup", 0, 1),
        ("h2g_finish", 0, 1),
    ]
    full = [
        ("miller_product", 16, 2),
        ("rlc_combine", 16, 1),
        # the mesh-sharded combine's per-shard chunk program: under a
        # mesh the chunk shrinks until every device holds at least one
        # chunk row (bls_backend._rlc_chunk — e.g. 16 candidates on 4
        # devices run as chunk-4 rows), so the analyzer's critical-path/
        # width report must cover the narrow-chunk shape too
        ("rlc_combine", 4, 1),
        ("hard_part", 0, 8),
        # the pipelined multi-row shape (_fold_for caps the new variants
        # at 8): by fold 8 the frobenius schedule is work-bound enough to
        # classify balanced — width now hides the residual depth
        ("hard_part_windowed", 0, 8),
        ("hard_part_frobenius", 0, 8),
        ("g1_subgroup", 0, 4),
        ("g2_subgroup", 0, 8),
        ("h2g_finish", 0, 4),
    ]
    shapes = small if tier1_only else small + full
    return [(f"{kind}[k={k},fold={fold}]", kind, k, fold)
            for kind, k, fold in shapes]


def run_registry(tier1_only: bool = False, export: bool = True,
                 progress=None) -> List[Dict]:
    """Build + analyze every registry program at the PRODUCTION assembly
    shape (bls_backend's lane widths and padding), optionally exporting
    summary gauges + per-program stats through the obs/ planes."""
    from . import bls_backend, vmlib

    reports = []
    for key, kind, k, fold in registry_programs(tier1_only):
        if progress is not None:
            progress(key)
        prog = vmlib.BUILDERS[kind](k, fold)
        reports.append(analyze_prog(
            prog, name=key,
            w_mul=bls_backend.W_MUL, w_lin=bls_backend.W_LIN,
            pad_steps_to=bls_backend.PAD_STEPS,
            # the exact production padding (_program's assemble call) so
            # n_regs — and the cost model scaled by it — match the
            # executable shape the device actually runs
            pad_regs_to=bls_backend._pow2(64)))
    if export:
        export_to_obs(reports)
    return reports


def export_to_obs(reports: List[Dict]) -> None:
    """Publish the analysis summary through the observability planes:
    per-program stats merge into the obs/programs trace registry (they
    ride the Chrome trace export's programRegistry key) and the vm.*
    summary gauges ride profiling.summary() / the /metrics endpoint."""
    from ..obs import programs as obs_programs
    from . import profiling

    for r in reports:
        obs_programs.note_analysis(
            r["name"],
            max_live=r["pressure"]["max_live"],
            critical_path=r["cost"]["critical_path"],
            classification=r["cost"]["classification"],
            predicted_row_s=r["cost"]["predicted_row_s"],
            errors=r["errors"],
            hazard=r["pressure"]["hazard"],
        )
    profiling.set_gauge("vm.analysis_programs", len(reports))
    profiling.set_gauge("vm.analysis_errors",
                        sum(r["errors"] for r in reports))
    profiling.set_gauge("vm.analysis_warnings",
                        sum(r["warnings"] for r in reports))
    profiling.set_gauge("vm.analysis_hazards",
                        sum(1 for r in reports if r["pressure"]["hazard"]))
    profiling.set_gauge("vm.analysis_max_live",
                        max((r["pressure"]["max_live"] for r in reports),
                            default=0))


# ---------------------------------------------------------------------------
# the baseline gate
# ---------------------------------------------------------------------------

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "VMLINT_BASELINE.json")  # the JAX package's baseline, read as data

# per-program scalars the baseline pins; regressions past the tolerance
# fail the gate (improvements only warn — update the baseline to ratchet)
BASELINE_KEYS = ("sched_steps", "critical_path", "max_live", "alloc_regs",
                 "mul_ops")
GATE_TOLERANCE = 0.05


def baseline_entry(report: Dict) -> Dict:
    return {
        "sched_steps": report["pressure"]["sched_steps"],
        "critical_path": report["cost"]["critical_path"],
        "max_live": report["pressure"]["max_live"],
        "alloc_regs": report["pressure"]["alloc_regs"],
        "mul_ops": report["cost"]["mul_ops"],
        # informational (NOT in BASELINE_KEYS — model constants move with
        # re-measurement): the fused-vs-interp prediction pair the
        # lowering decision reads off the committed baseline
        "predicted_row_s": report["cost"]["predicted_row_s"],
        "predicted_fused_row_s": report["cost"]["predicted_fused_row_s"],
        # informational too: the structural-dedup shape — how many
        # distinct chunk structures the fused backend compiles per program
        # and the cold-compile prediction that buys
        "distinct_structs": report["structure"]["distinct_structs"],
        "struct_chunks": report["structure"]["chunks"],
        "dedup_ratio": report["structure"]["dedup_ratio"],
        "predicted_cold_s": report["structure"]["predicted_cold_s"],
    }


def load_baseline(path: str = None) -> Dict:
    with open(path or BASELINE_PATH) as fh:
        return json.load(fh)


def gate(reports: List[Dict], baseline: Dict,
         tolerance: float = GATE_TOLERANCE) -> List[str]:
    """Failure strings (empty = pass): any soundness error or hazard in any
    report, any program missing from the baseline, any pinned scalar grown
    past baseline * (1 + tolerance)."""
    failures = []
    for r in reports:
        name = r["name"]
        for f in r["findings"]:
            if f["severity"] == "error":
                where = f" op {f['op']}" if "op" in f else ""
                failures.append(
                    f"{name}:{where} [{f['rule']}] {f['detail']}")
        base = baseline.get(name)
        if base is None:
            failures.append(
                f"{name}: not in VMLINT_BASELINE.json — analyze it and "
                "commit the entry (tools/torch_vmlint.py --update-baseline)")
            continue
        cur = baseline_entry(r)
        for key in BASELINE_KEYS:
            if key not in base:
                continue
            if cur[key] > base[key] * (1 + tolerance):
                failures.append(
                    f"{name}: {key} regressed {base[key]} -> {cur[key]} "
                    f"(> {tolerance:.0%} tolerance) — fix the regression "
                    "or consciously re-baseline with --update-baseline")
    return failures
