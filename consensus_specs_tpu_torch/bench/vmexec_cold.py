"""Fresh-process time to a fused-ready program: the port's counterpart of
consensus_specs_tpu/bench/vmexec_cold.py.

    python -m consensus_specs_tpu_torch.bench.vmexec_cold [--device cpu]
        [--smoke]

Run as a CHILD process, so that nothing is warm: it measures the wall
seconds from process entry (imports included) to a fused-ready program:
``bls_backend._program`` (assembly, with the native scheduler where it
builds), the structural plan derived or loaded, and ``warm_fused`` for one
batch shape, which on the card captures the units' CUDA graphs (there is
no compile). Then one fused execution is compared with the interpreter,
limb for limb. Prints one line::

    VMEXEC_COLD_JSON {"ok": true, "ready_s": ..., "distinct_structs": ...}

The vmexec bench runs it once an arm, each against a fresh
``CONSENSUS_SPECS_TPU_VM_CACHE``; ``--smoke`` makes that fresh directory
itself (deleted on the way out) and exits 1 unless the program became
fused-ready and limb-identical.

Env: VMEXEC_COLD_KIND (default g2_subgroup), VMEXEC_COLD_K (default 0),
VMEXEC_COLD_ROWS (default 1), VMEXEC_COLD_SEED (default 5),
VMEXEC_COLD_BUDGET_S (default 180).
"""
import json
import os
import random
import sys
import time


def main(argv=None) -> int:
    t0 = time.monotonic()
    args = sys.argv[1:] if argv is None else list(argv)
    smoke = "--smoke" in args
    device_name = None
    if "--device" in args and args.index("--device") + 1 < len(args):
        device_name = args[args.index("--device") + 1]
    smoke_cache = None
    if smoke:
        import tempfile

        smoke_cache = tempfile.mkdtemp(prefix="vmexec_cold_")
        os.environ["CONSENSUS_SPECS_TPU_VM_CACHE"] = os.path.join(
            smoke_cache, "vm")

    kind = os.environ.get("VMEXEC_COLD_KIND", "g2_subgroup")
    k = int(os.environ.get("VMEXEC_COLD_K", "0") or 0)
    rows = int(os.environ.get("VMEXEC_COLD_ROWS", "1") or 1)
    budget_s = float(os.environ.get("VMEXEC_COLD_BUDGET_S", "180"))

    import numpy as np

    from ..device import resolve_device
    from ..ops import bls_backend as bb, fq, vm, vm_compile
    from ..utils import bls12_381 as O

    result = {"ok": False, "kind": kind, "rows": rows,
              "dedup": vm_compile.dedup_enabled(), "budget_s": budget_s}
    try:
        device = resolve_device(device_name)
        result["device"] = str(device)
        program, _fold = bb._program(kind, k, 1)
        t_prog = time.monotonic()
        fp = vm_compile.fused_program(program)
        t_plan = time.monotonic()
        warm_s = vm_compile.warm_fused(program, (rows,), device=device)
        ready_s = time.monotonic() - t0
        result.update(
            ready_s=round(ready_s, 3),
            program_s=round(t_prog - t0, 3),
            plan_s=round(t_plan - t_prog, 3),
            warm_s=round(warm_s, 3),
            within_budget=bool(ready_s <= budget_s),
            struct_misses=vm_compile._COUNTERS["struct_misses"],
            captures=vm_compile._COUNTERS["captures"],
            native_scheduler=vm.native_sched() is not None,
            **fp.struct_stats,
        )
        rng = random.Random(int(os.environ.get("VMEXEC_COLD_SEED", "5")))
        ins = {name: np.stack([fq.to_mont_int(rng.randrange(O.P))
                               for _ in range(rows)])
               for name in program.input_names}
        os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = "fused"
        out_f = vm.execute(program, ins, batch_shape=(rows,), device=device)
        os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = "interp"
        out_i = vm.execute(program, ins, batch_shape=(rows,), device=device)
        identical = set(out_f) == set(out_i) and all(
            np.array_equal(out_f[name], out_i[name]) for name in out_f)
        result["identical"] = bool(identical)
        result["fallbacks"] = vm_compile._COUNTERS["fallbacks"]
        result["ok"] = bool(identical and not result["fallbacks"])
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"[:300]

    print("VMEXEC_COLD_JSON " + json.dumps(result), flush=True)
    if smoke_cache:
        import shutil

        shutil.rmtree(smoke_cache, ignore_errors=True)
    if smoke:
        if not result["ok"]:
            print(f"vmexec-cold-smoke FAIL: {result}")
            return 1
        verdict = "within" if result.get("within_budget") else "OVER"
        print(f"vmexec-cold-smoke: OK — {kind} rows={rows} fused-ready in "
              f"{result['ready_s']}s ({result['distinct_structs']} distinct "
              f"structures / {result['chunks']} chunks, window "
              f"{result['window']}), {verdict} the {budget_s:.0f}s budget")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
