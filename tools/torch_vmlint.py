"""torch_vmlint — the static-analysis gate for the port's field-ALU VM
programs, the counterpart of tools/vmlint.py.

Analyzes every program in the port's vmlib registry (Miller product,
aggregate verify, RLC combine, hard part, the subgroup-check ladders, the
hash-to-G2 finish) at the production assembly shape through
consensus_specs_tpu_torch/ops/vm_analysis.py, which imports nothing of the
JAX package and reads VMLINT_BASELINE.json as data:

- independently re-derives every value-magnitude bound and cross-checks the
  assembler's inline tracker (carry-safety of the 15-limb lanes);
- reports per-program register pressure and flags the live-range-outlier
  scheduler hazard (the select-then-multiply register blowup class);
- reports the critical path / width profile / predicted runtime and the
  depth-bound vs width-bound classification;
- reports the structural-dedup shape: distinct canonical chunk structures
  vs total chunks at the fused backend's period-aligned window, the dedup
  ratio, and the predicted cold bill with and without dedup;
- gates against the committed VMLINT_BASELINE.json: any soundness error,
  any hazard, and any pressure/depth scalar grown past the tolerance fails.

Exit status 0 = clean. Usage:

    python tools/torch_vmlint.py                  # full registry + gate
    python tools/torch_vmlint.py --tier1          # small-shape subset
    python tools/torch_vmlint.py --update-baseline  # re-pin the baseline
    python tools/torch_vmlint.py --json out.json  # dump the full reports
    python tools/torch_vmlint.py --no-gate        # reports only

The two packages emit the same programs, so their reports and the one
baseline agree (tests/test_torch_vm_analysis.py holds the reports equal);
re-pin from either tool. Building the IR and the structural plans dominate
the run time; the tests analyze the tier-1 subset.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)



def _fmt_line(r: dict) -> str:
    p, c = r["pressure"], r["cost"]
    s = r["structure"]
    # pred / fused: the JAX package's interpreter and lowering cost
    # models (ops/vm_analysis.py COST_* and FUSED_COST_*); structs: the
    # dedup shape, distinct canonical chunk structures / total chunks at
    # the period-aligned window, and the predicted cold bill that buys
    # (against the per-chunk bill)
    return (
        f"{r['name']:<36} steps={p['sched_steps']:<6} "
        f"crit={c['critical_path']:<6} work={c['work_steps']:<5} "
        f"{c['classification']:<11} live={p['max_live']:<5} "
        f"regs={p['alloc_regs']:<5} mulutil={c['mul_utilization']:<7} "
        f"pred={c['predicted_row_s']:.2f}s/row "
        f"fused={c['predicted_fused_row_s']:.2f}s/row "
        f"structs={s['distinct_structs']}/{s['chunks']} "
        f"({s['dedup_ratio']}x, cold~{s['predicted_cold_s']:.0f}s"
        f"/{s['predicted_cold_nodedup_s']:.0f}s) "
        f"err={r['errors']} warn={r['warnings']}"
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier1", action="store_true",
                    help="analyze only the small-shape tier-1 subset")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite VMLINT_BASELINE.json from this run "
                         "(full registry required)")
    ap.add_argument("--json", metavar="PATH",
                    help="dump the full report list as JSON")
    ap.add_argument("--no-gate", action="store_true",
                    help="skip the baseline comparison")
    args = ap.parse_args()

    from consensus_specs_tpu_torch.ops import vm_analysis

    if args.update_baseline and args.tier1:
        ap.error("--update-baseline needs the full registry (drop --tier1)")

    reports = vm_analysis.run_registry(
        tier1_only=args.tier1,
        progress=lambda key: print(f"vmlint: analyzing {key} ...",
                                   flush=True),
    )
    print()
    for r in reports:
        print(_fmt_line(r))
        for f in r["findings"]:
            print(f"    [{f['severity']}] {f['rule']}: {f['detail']}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(reports, fh, indent=1, sort_keys=True)
        print(f"\nvmlint: full reports -> {args.json}")

    if args.update_baseline:
        baseline = {r["name"]: vm_analysis.baseline_entry(r)
                    for r in reports}
        with open(vm_analysis.BASELINE_PATH, "w") as fh:
            json.dump(baseline, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"vmlint: baseline re-pinned -> {vm_analysis.BASELINE_PATH}")
        # still gate against the fresh baseline: soundness errors/hazards
        # must fail even while re-pinning the scalars

    failures = []
    if args.no_gate:
        failures = [
            f"{r['name']}: [{f['rule']}] {f['detail']}"
            for r in reports for f in r["findings"]
            if f["severity"] == "error"
        ]
    else:
        try:
            baseline = vm_analysis.load_baseline()
        except FileNotFoundError:
            print("vmlint: VMLINT_BASELINE.json missing — run "
                  "tools/torch_vmlint.py --update-baseline and commit it")
            return 1
        # gate() iterates the analyzed reports, so a --tier1 run simply
        # checks the subset against its baseline entries
        failures = vm_analysis.gate(reports, baseline)

    print()
    for f in failures:
        print(f"vmlint FAIL: {f}")
    print(f"vmlint: {len(reports)} program(s), {len(failures)} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
