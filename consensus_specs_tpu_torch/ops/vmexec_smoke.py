"""Execution-route identity canary: the port's counterpart of
consensus_specs_tpu/ops/vmexec_smoke.py.

    python -m consensus_specs_tpu_torch.ops.vmexec_smoke [--device cpu]

Holds the fused straight-line lowering (ops/vm_compile.py) to limb
identity with the interpreter AND to the exact-int IR oracle
(``vm_analysis.eval_ir``: the same Montgomery-domain integer map over the
pre-assembly IR) on registry programs fed random field inputs, on the
batch axis (VMEXEC_SMOKE_ROWS, default 3): every named output, every limb,
on the loose representative (stronger than agreement mod p).

The default set is one cheap program per structural class (a subgroup
ladder and a Miller product); VMEXEC_SMOKE_FULL=1 sweeps every kind of
``vmlib.BUILDERS`` at fold 1. The flight recorder is armed, and on a
failure its journal (``vm/fused_compile`` and ``vm/fused_fallback`` events
among them) dumps to ``vmexec_flight.jsonl``. Exit 0 on a pass, 1 with a
diagnosis line otherwise. Without ``--device cpu`` it runs on the card.
"""
import os
import random
import sys

SEED = int(os.environ.get("VMEXEC_SMOKE_SEED", "13"))

DEFAULT_SET = (
    ("g2_subgroup", 0, 1),
    ("miller_product", 1, 1),
)


def _full_set():
    from . import vmlib

    return tuple(
        (kind, 2 if kind in ("miller_product", "aggregate_verify",
                             "rlc_combine") else 0, 1)
        for kind in sorted(vmlib.BUILDERS))


def main(device=None) -> int:
    # the flight recorder armed for this run only: an in-process caller
    # (a test) keeps its own environment afterwards
    prev_env = {
        k: os.environ.get(k)
        for k in ("CONSENSUS_SPECS_TPU_FLIGHT",
                  "CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                  "CONSENSUS_SPECS_TPU_VM_EXEC")
    }
    os.environ["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"
    os.environ.setdefault("CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                          "vmexec_flight.jsonl")

    import numpy as np

    from ..device import resolve_device
    from ..obs import flight
    from ..utils import bls12_381 as O
    from . import bls_backend as bb, fq, vm, vm_analysis, vm_compile, vmlib

    rng = random.Random(SEED)
    cases = (_full_set() if os.environ.get("VMEXEC_SMOKE_FULL") == "1"
             else DEFAULT_SET)
    rows_list = tuple(
        int(x) for x in os.environ.get("VMEXEC_SMOKE_ROWS", "3").split(",")
        if x)
    failures = []
    try:
        dev = resolve_device(device)
        fallbacks = vm_compile._COUNTERS["fallbacks"]
        for kind, k, fold in cases:
            prog = vmlib.BUILDERS[kind](k, fold)
            assembled = prog.assemble(
                w_mul=bb.W_MUL, w_lin=bb.W_LIN, pad_steps_to=bb.PAD_STEPS,
                pad_regs_to=bb._pow2(64))
            label = f"{kind}[k={k},fold={fold}]"
            print(f"vmexec-smoke: {label} steps={assembled.n_steps} "
                  f"regs={assembled.n_regs}", flush=True)
            for rows in rows_list:
                ins_ints = [{name: rng.randrange(O.P)
                             for name in assembled.input_names}
                            for _ in range(rows)]
                ins = {name: np.stack([fq.to_mont_int(row[name])
                                       for row in ins_ints])
                       for name in assembled.input_names}
                outs = {}
                for mode in ("interp", "fused"):
                    os.environ["CONSENSUS_SPECS_TPU_VM_EXEC"] = mode
                    outs[mode] = vm.execute(assembled, ins,
                                            batch_shape=(rows,), device=dev)
                out_i, out_f = outs["interp"], outs["fused"]
                for name in out_i:
                    if not np.array_equal(out_i[name], out_f[name]):
                        failures.append(f"{label} rows={rows}: fused != "
                                        f"interp on output {name!r}")
                        break
                for r in range(rows):
                    want = vm_analysis.eval_ir(prog, ins_ints[r])
                    for name, w in want.items():
                        got_i = fq.limbs_to_int(out_i[name][r])
                        got_f = fq.limbs_to_int(out_f[name][r])
                        if got_i != w or got_f != w:
                            failures.append(
                                f"{label} rows={rows} row={r} output "
                                f"{name!r}: oracle={w} interp={got_i} "
                                f"fused={got_f}")
                            break
        if vm_compile._COUNTERS["fallbacks"] != fallbacks:
            failures.append("the fused route fell back to the interpreter")
    except Exception as e:
        failures.append(f"crashed: {type(e).__name__}: {e}")

    if failures:
        for f in failures:
            print(f"vmexec-smoke FAIL: {f}")
        path = flight.global_recorder().dump(reason="vmexec_smoke_failure")
        if path:
            print(f"vmexec-smoke: flight journal dumped to {path}")
    for k, v in prev_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if failures:
        return 1
    print(f"vmexec-smoke: OK — {len(cases)} program(s) x rows {rows_list} "
          "fused == interp == exact-int oracle")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(args[args.index("--device") + 1]
                  if "--device" in args else None))
