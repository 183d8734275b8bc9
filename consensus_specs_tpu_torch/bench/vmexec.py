"""VM execution-route microbenchmark: the port's counterpart of
consensus_specs_tpu/bench/vmexec.py (``--mode vmexec`` of the bench entry).

Races the INTERPRETER (on the card: the step kernel, one launch a call)
against the FUSED straight-line lowering (ops/vm_compile.py; on the card:
the Montgomery kernel in CUDA graphs, one graph a unit) on the same
assembled programs and random field inputs, per (program kind, rows)
cell:

  vmexec[kind,rows] -> {
    ok              fused outputs limb-identical to the interpreter's,
    interp_ms_row   warm interpreter wall ms / row,
    fused_ms_row    warm fused wall ms / row,
    fused_compile_s seconds ``warm_fused`` took to build the cell's units
                    (on the card: graph captures; 0.0 when built),
    speedup         interp_ms_row / fused_ms_row,
    interp_launches step-kernel launches of one warm interpreter call,
    fused_launches  Montgomery-kernel launches of one warm fused call
                    (the products in its graphs' replays),
    captures        graphs captured for the cell,
    auto_fused      whether ``CONSENSUS_SPECS_TPU_VM_EXEC=auto`` then
                    routes the cell fused, and auto_ok that this is the
                    measured winner of the program's ms/row ledger,
  }

Every warm fused cell persists its measured ms/row pair into the
program's plan under ``.vm_cache_torch/``, which later processes' ``auto``
route reads.

COLD CELLS: after the warm race, one child process an arm
(bench/vmexec_cold.py) against a fresh ``CONSENSUS_SPECS_TPU_VM_CACHE``
measures the time from process entry to a fused-ready program (program
assembly, plan derivation and the units of one batch shape: on the card
graph captures, no compile): ``cold,<kind>`` (structural dedup on; ok
also requires ready_s within VMEXEC_COLD_BUDGET_S, default 180) and
``cold_nodedup,<kind>`` (a structure per chunk); ``cold_speedup`` is their
ready_s ratio.

Env (the JAX bench's): VMEXEC_KINDS (default "g2_subgroup,h2g_finish,
hard_part_frobenius"), VMEXEC_ROWS (default "1,8"), VMEXEC_REPS (default
2), VMEXEC_K (default 2, for the kinds with a per-item size), VMEXEC_SEED
(default 7), VMEXEC_COLD (1 both cold arms, "dedup" the dedup arm only, 0
none), VMEXEC_COLD_KIND, VMEXEC_COLD_BUDGET_S, VMEXEC_COLD_TIMEOUT_S.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

DEFAULT_KINDS = "g2_subgroup,h2g_finish,hard_part_frobenius"
_K_KINDS = ("miller_product", "aggregate_verify", "rlc_combine")


def _timed(fn) -> float:
    """Wall seconds of ``fn()`` (the JAX package's bench/finalexp._timed;
    ``vm.execute`` returns host arrays, so the card has finished)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _run_cold_arm(dedup: bool, device) -> dict:
    """One fresh child process against a fresh program cache (deleted
    afterwards): returns the child's VMEXEC_COLD_JSON payload, or an error
    cell."""
    timeout_s = float(os.environ.get("VMEXEC_COLD_TIMEOUT_S", "1800"))
    env = dict(os.environ)
    cache_dir = tempfile.mkdtemp(prefix="vmexec_cold_")
    env["CONSENSUS_SPECS_TPU_VM_CACHE"] = os.path.join(cache_dir, "vm")
    env["CONSENSUS_SPECS_TPU_VM_DEDUP"] = "1" if dedup else "0"
    env.pop("CONSENSUS_SPECS_TPU_VM_EXEC", None)
    argv = [sys.executable, "-m", "consensus_specs_tpu_torch.bench.vmexec_cold"]
    if device.type != "cuda":
        argv += ["--device", str(device)]
    try:
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              timeout=timeout_s)
        for line in proc.stdout.splitlines():
            if line.startswith("VMEXEC_COLD_JSON "):
                return json.loads(line[len("VMEXEC_COLD_JSON "):])
        return {"ok": False,
                "error": f"no cold JSON (rc={proc.returncode}): "
                         f"{proc.stderr[-200:]}"}
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"timeout after {timeout_s:.0f}s"}
    except Exception as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:200]}
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _cell(program, rows, reps, rng, device) -> dict:
    """One (program, rows) cell: the interpreter warm and timed, the
    fused units built and the fused route timed, outputs compared, and
    the auto route read back."""
    from ..ops import cuda_fq, cuda_step, fq, vm, vm_compile
    from ..utils import bls12_381 as O

    ins = {name: np.stack([fq.to_mont_int(rng.randrange(O.P))
                           for _ in range(rows)])
           for name in program.input_names}
    bs = (rows,)
    run = lambda: vm.execute(program, ins, batch_shape=bs, device=device)

    os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = "interp"
    out_i = run()  # warm
    before = cuda_step.LAUNCHES
    interp_s = min(_timed(run) for _ in range(reps))
    interp_launches = (cuda_step.LAUNCHES - before) // reps

    os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = "fused"
    captures = vm_compile._COUNTERS["captures"]
    compile_s = vm_compile.warm_fused(program, bs, device=device)
    captures = vm_compile._COUNTERS["captures"] - captures
    out_f = run()
    before = cuda_fq.LAUNCHES
    fused_s = min(_timed(run) for _ in range(reps))
    fused_launches = (cuda_fq.LAUNCHES - before) // reps

    identical = set(out_i) == set(out_f) and all(
        np.array_equal(out_i[name], out_f[name]) for name in out_i)
    os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = "auto"
    auto_fused = vm_compile.use_fused(
        program, shape_sig=vm_compile.shape_sig(bs, device))
    st = program._exec_stats
    winner_fused = st["fused_ms_row"] < st["interp_ms_row"]
    cell = dict(
        ok=bool(identical and auto_fused == winner_fused),
        interp_ms_row=round(interp_s * 1e3 / rows, 3),
        fused_ms_row=round(fused_s * 1e3 / rows, 3),
        fused_compile_s=round(compile_s, 3),
        speedup=round(interp_s / fused_s, 3) if fused_s else None,
        interp_launches=interp_launches,
        fused_launches=fused_launches,
        captures=captures,
        auto_fused=bool(auto_fused),
        auto_ok=bool(auto_fused == winner_fused),
    )
    if not identical:
        cell["error"] = "fused != interp (limbs)"
    elif auto_fused != winner_fused:
        cell["error"] = "auto did not pick the measured winner"
    return cell


def run_vmexec_bench(device) -> dict:
    import random

    import torch

    from ..ops import bls_backend as bb, vm_compile

    device = torch.device(device)
    kinds = [k for k in os.environ.get("VMEXEC_KINDS", DEFAULT_KINDS)
             .split(",") if k]
    rows_list = [int(x) for x in os.environ.get("VMEXEC_ROWS", "1,8")
                 .split(",") if x.strip()]
    reps = max(1, int(os.environ.get("VMEXEC_REPS", "2")))
    k_items = int(os.environ.get("VMEXEC_K", "2"))
    rng = random.Random(int(os.environ.get("VMEXEC_SEED", "7")))

    section = {}
    best_speedup = 0.0
    prev_mode = os.environ.get("CONSENSUS_SPECS_TPU_VM_EXEC")
    fallbacks = vm_compile._COUNTERS["fallbacks"]
    try:
        for kind in kinds:
            try:
                k = k_items if kind in _K_KINDS else 0
                program, _fold = bb._program(kind, k, 1)
            except Exception as e:
                for r in rows_list:
                    section[f"{kind},{r}"] = {
                        "ok": False,
                        "error": f"build: {type(e).__name__}: {e}"[:200]}
                continue
            for r in rows_list:
                try:
                    cell = _cell(program, r, reps, rng, device)
                except Exception as e:
                    cell = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"[:200]}
                section[f"{kind},{r}"] = cell
                if cell["ok"] and cell.get("speedup"):
                    best_speedup = max(best_speedup, cell["speedup"])
    finally:
        if prev_mode is None:
            os.environ.pop("CONSENSUS_SPECS_TPU_VM_EXEC", None)
        else:
            os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = prev_mode
    fallbacks = vm_compile._COUNTERS["fallbacks"] - fallbacks

    cold_mode = os.environ.get("VMEXEC_COLD", "1")
    cold_speedup = None
    if cold_mode != "0":
        cold_kind = os.environ.get("VMEXEC_COLD_KIND", "g2_subgroup")
        dedup_cell = _run_cold_arm(True, device)
        dedup_cell["ok"] = bool(dedup_cell.get("ok")
                                and dedup_cell.get("within_budget"))
        section[f"cold,{cold_kind}"] = dedup_cell
        if cold_mode != "dedup":
            base_cell = _run_cold_arm(False, device)
            section[f"cold_nodedup,{cold_kind}"] = base_cell
            if dedup_cell.get("ready_s") and base_cell.get("ready_s"):
                cold_speedup = round(
                    base_cell["ready_s"] / dedup_cell["ready_s"], 3)

    return dict(
        metric="best fused-over-interp VM execution speedup (warm ms/row)",
        value=round(best_speedup, 3),
        vs_baseline=round(best_speedup, 3),
        unit="x",
        mode="vmexec",
        ok=bool(section) and all(c.get("ok") for c in section.values())
        and fallbacks == 0,
        fused_fallbacks=fallbacks,
        kinds=kinds,
        rows=rows_list,
        reps=reps,
        chunk_steps=vm_compile.chunk_steps(),
        cold_speedup=cold_speedup,
        vmexec=section,
    )
