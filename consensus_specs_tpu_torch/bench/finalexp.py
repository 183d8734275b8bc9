"""Final-exponentiation hard-part microbenchmark: the port's counterpart
of consensus_specs_tpu/bench/finalexp.py (``--mode finalexp`` of the bench
entry).

Races the host-oracle HHT against every VM hard-part variant on identical
unitary rows, at rows in {1, 2, 4, 8} (FINALEXP_ROWS):

  host        exact-int oracle HHT, one element at a time;
  bit_serial  the depth-bound chain (4864 padded steps at any fold);
  windowed    HHT with sliding-window ladders over depth-lean component
              cyclotomic squarings;
  frobenius   the lambda-decomposed spine variant: rows >= 2 fold onto
              the program row, so ms/row drops with pipelining.

On the card every VM cell is one ``vm.execute``: one step-kernel launch.

Plus the execution-route cells: "frobenius_interp1,<rows>" and
"frobenius_fused,<rows>" run the frobenius variant at fold 1 (rows on the
batch axis) under CONSENSUS_SPECS_TPU_VM_EXEC=interp and =fused (the
straight-line lowering of ops/vm_compile.py: on the card, the Montgomery
kernel in CUDA graphs) at FINALEXP_FUSED_ROWS (default "1,8"); the
variable's earlier value is restored after them.

Every VM execution's verdict must be True on the valid rows: an errored or
wrong-verdict variant marks its cell ok=false. A device cell merely slower
than the host is report-only.

The JSON line also carries:
  crit_path   vm_analysis critical-path depths per variant + the ratio vs
              the 4864-step padded chain;
  assembler   the bucketed-vs-legacy scheduler race on the chunk-16
              rlc_combine (ops/sec both ways, cold-assembly seconds,
              whether the native scheduler ran);
  bars        the JAX package's acceptance predicates, computed as they
              are (``depth_2_5x``, ``ms_per_row_3x``, ``assembler_4x``,
              ``cold_assembly_2s``, ``fused_3x_<rows>``); a false bar is
              reported, not failed.

Env (the JAX bench's): FINALEXP_ROWS (default "1,2,4,8"),
FINALEXP_FUSED_ROWS (default "1,8"), FINALEXP_REPS (default 1),
FINALEXP_SEED (default 7).
"""
import os
import time

import numpy as np


def _timed(fn) -> float:
    """Wall seconds of ``fn()`` (``vm.execute`` returns host arrays, so
    the card has finished)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _build_g_rows(seed: int, n: int, device) -> "tuple":
    """(n, 12, L) Montgomery rows of VALID unitary hard-part inputs (the
    easy part of real verification f's, made by PROG A on ``device``) +
    their exact flat coefficients. Valid rows make every variant's
    verdict True, so a wrong formula is an immediate ok=false."""
    from ..ops import bls_backend as bb, fq
    from .rlc_final import _build_f_rows

    fs = _build_f_rows(seed, device)
    rows = []
    coeffs = []
    for i in range(n):
        f = [fq.from_mont_limbs(fs[i % fs.shape[0], j]) for j in range(12)]
        g = bb._easy_part_flat(f)
        assert g is not None
        coeffs.append(g)
        rows.append(np.stack([fq.to_mont_int(c) for c in g]))
    return np.stack(rows), coeffs


def run_finalexp_bench(device=None) -> dict:
    from ..device import resolve_device
    from ..ops import bls_backend as bb, vm as vm_mod, vm_analysis, vmlib

    dev = resolve_device(device)
    rows_list = [
        int(x)
        for x in os.environ.get("FINALEXP_ROWS", "1,2,4,8").split(",")
    ]
    reps = max(1, int(os.environ.get("FINALEXP_REPS", "1")))
    seed = int(os.environ.get("FINALEXP_SEED", "7"))

    max_rows = max(rows_list)
    g_rows, g_coeffs = _build_g_rows(seed, max_rows, dev)

    section = {}

    def put(variant, rows, ms, ok=True, err=None):
        cell = {"ok": bool(ok),
                "ms_per_row": round(ms / rows, 2) if ms else None}
        if err:
            cell["error"] = str(err)[:200]
        section[f"{variant},{rows}"] = cell

    # host oracle: one exact-int HHT per row
    for r in rows_list:
        def host_all():
            for c in g_coeffs[:r]:
                assert bb._hard_part_is_one_oracle(c)
        host_all()  # warm (pure python; also validates)
        dt = min(_timed(host_all) for _ in range(reps))
        put("host", r, dt * 1e3)

    # the one canonical variant-name -> program-kind map (bls_backend owns
    # routing; the bench races exactly what production can serve)
    variants = dict(bb._HARD_PART_KINDS)
    for variant, kind in variants.items():
        for r in rows_list:
            sub = g_rows[:r]
            try:
                ok = bb._run_hard_part(sub, dev, kind=kind)  # warm + verdict
                if not ok.all():
                    put(variant, r, 0.0, ok=False,
                        err="wrong verdict on valid rows")
                    continue
                dt = min(
                    _timed(lambda: bb._run_hard_part(sub, dev, kind=kind))
                    for _ in range(reps)
                )
                put(variant, r, dt * 1e3)
            except Exception as e:
                put(variant, r, 0.0, ok=False, err=f"{type(e).__name__}: {e}")

    # the execution-route race: the frobenius hard part at fold 1, rows on
    # the batch axis, through the interpreter ("frobenius_interp1") and
    # the fused straight-line lowering ("frobenius_fused") on the same
    # program and inputs; the first fused call of a shape builds its units
    # outside the timed reps. These cells decide the fused_3x bars, so
    # they take the min of at least 3 reps.
    fused_rows = [
        int(x)
        for x in os.environ.get("FINALEXP_FUSED_ROWS", "1,8").split(",")
        if x and int(x) <= max_rows
    ]
    race_reps = max(3, reps)
    prev_exec = os.environ.get("CONSENSUS_SPECS_TPU_VM_EXEC")
    try:
        for variant, mode in (("frobenius_interp1", "interp"),
                              ("frobenius_fused", "fused")):
            os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = mode
            for r in fused_rows:
                sub = g_rows[:r]
                try:
                    ok = bb._run_hard_part(
                        sub, dev, kind=variants["frobenius"], fold=1)
                    if not ok.all():
                        put(variant, r, 0.0, ok=False,
                            err="wrong verdict on valid rows")
                        continue
                    dt = min(
                        _timed(lambda: bb._run_hard_part(
                            sub, dev, kind=variants["frobenius"], fold=1))
                        for _ in range(race_reps)
                    )
                    put(variant, r, dt * 1e3)
                except Exception as e:
                    put(variant, r, 0.0, ok=False,
                        err=f"{type(e).__name__}: {e}")
    finally:
        if prev_exec is None:
            os.environ.pop("CONSENSUS_SPECS_TPU_VM_EXEC", None)
        else:
            os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = prev_exec

    # critical paths (fold-1 shapes), vs the padded bit-serial chain
    legacy_padded = 4864
    shape = dict(w_mul=bb.W_MUL, w_lin=bb.W_LIN,
                 pad_steps_to=bb.PAD_STEPS, pad_regs_to=bb._pow2(64))
    crit = {}
    for variant, kind in variants.items():
        rep = vm_analysis.analyze_prog(vmlib.BUILDERS[kind](0, 1), name=kind,
                                       **shape)
        crit[variant] = rep["cost"]["critical_path"]
    best_crit = min(crit["windowed"], crit["frobenius"])
    crit_section = dict(crit, legacy_padded=legacy_padded,
                        best_ratio=round(legacy_padded / best_crit, 2))

    # assembler race: bucketed (+ the native scheduler when built) vs the
    # legacy list scheduler on the chunk-16 rlc_combine
    prog = vmlib.build_rlc_combine(16, 1)
    n_ops = len(prog.ops)
    new_s = min(
        _timed(lambda: prog.assemble(annotate=False, **shape))
        for _ in range(2)
    )
    legacy_s = _timed(lambda: prog.assemble_legacy(**shape))
    assembler = {
        "ops": n_ops,
        "new_s": round(new_s, 3),
        "legacy_s": round(legacy_s, 3),
        "new_ops_per_s": round(n_ops / new_s, 0),
        "legacy_ops_per_s": round(n_ops / legacy_s, 0),
        "speedup": round(legacy_s / new_s, 2),
        "native_kernel": vm_mod.native_sched() is not None,
    }

    def ms(variant, r):
        cell = section.get(f"{variant},{r}")
        return cell["ms_per_row"] if cell and cell["ok"] else None

    base_1row = ms("bit_serial", 1)
    pipelined = [
        ms(v, r)
        for v in ("windowed", "frobenius")
        for r in rows_list
        if r >= 2 and ms(v, r)
    ]
    best_pipelined = min(pipelined) if pipelined else None
    bars = {
        "depth_2_5x": legacy_padded >= 2.5 * best_crit,
        "ms_per_row_3x": bool(
            base_1row and best_pipelined
            and base_1row >= 3.0 * best_pipelined),
        "assembler_4x": assembler["speedup"] >= 4.0,
        "cold_assembly_2s": new_s <= 2.0,
    }
    # the fused lowering against the interpreter on the IDENTICAL fold-1
    # program at the same rows (>= 3x)
    for r in fused_rows:
        bars[f"fused_3x_{r}"] = bool(
            ms("frobenius_interp1", r) and ms("frobenius_fused", r)
            and ms("frobenius_interp1", r)
            >= 3.0 * ms("frobenius_fused", r))

    best_rows = max(
        (r for r in rows_list
         if any(ms(v, r) for v in ("windowed", "frobenius"))),
        default=max_rows)
    best_ms = min(
        (ms(v, best_rows) for v in ("windowed", "frobenius")
         if ms(v, best_rows)),
        default=None)
    value = 1e3 / best_ms if best_ms else 0.0  # rows/sec, higher-better
    return dict(
        metric="hard-part finalization rows/sec (best VM variant, "
               f"{best_rows} pipelined rows)",
        value=round(value, 2),
        vs_baseline=round(
            (base_1row / best_pipelined) / 3.0, 3
        ) if (base_1row and best_pipelined) else 0.0,
        mode="finalexp",
        rows=rows_list,
        reps=reps,
        final=bb._rlc_final_mode(dev),
        finalexp=section,
        crit_path=crit_section,
        assembler=assembler,
        bars=bars,
    )
