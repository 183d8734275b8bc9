"""Vector-tree sanity checker of the PyTorch/CUDA port: validate an emitted
test-vector tree's layout and completeness (the consumer-side counterpart
of the port's gen/gen_runner), the counterpart of tools/check_vectors.py.
It decompresses with the port's own snappy (consensus_specs_tpu_torch/
utils/snappy.py) and imports nothing of jax or of the JAX package; its
counts, report and verdict on a tree are tools/check_vectors.py's
(tests/test_torch_check_vectors.py holds them equal).

Checks, per the reference's <preset>/<fork>/<runner>/<handler>/<suite>/<case>
hierarchy (reference gen_helpers/gen_base/gen_runner.py:121-125):
- every case directory sits at exactly depth 6 and contains at least one
  part file (*.yaml / *.ssz_snappy);
- no INCOMPLETE sentinels remain (crash containment: a sentinel means the
  producing run died mid-case, gen_runner.py INCOMPLETE lifecycle);
- ssz_snappy parts decompress with the repo's own codec.

Usage: python tools/torch_check_vectors.py VECTORS_DIR [--decode-sample N]
                                           [--report PATH]
Prints a per-runner case-count table and exits nonzero on any violation.
``--report`` additionally writes the table + verdict as a markdown file —
the same markdown tools/check_vectors.py writes, DETERMINISTIC for a
given tree (no timestamp, no absolute paths).
"""
import argparse
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def scan_tree(root):
    """Walk a vector tree; returns (counts, incomplete, empty_cases,
    snappy_parts) where counts maps (preset, fork, runner) -> case count.
    Pure data gathering — shared by the CLI below and the committed-report
    staleness test."""
    incomplete = []
    empty_cases = []
    counts = {}  # (preset, fork, runner) -> cases
    snappy_parts = []

    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        parts = [] if rel == "." else rel.split(os.sep)
        if "INCOMPLETE" in filenames or "INCOMPLETE" in dirnames:
            incomplete.append(rel)
        if len(parts) == 6:  # a case dir
            data_files = [
                f for f in filenames
                if f.endswith((".yaml", ".ssz_snappy"))
            ]
            if not data_files:
                empty_cases.append(rel)
            key = tuple(parts[:3])
            counts[key] = counts.get(key, 0) + 1
            snappy_parts.extend(
                os.path.join(dirpath, f) for f in filenames
                if f.endswith(".ssz_snappy")
            )
    return counts, incomplete, empty_cases, snappy_parts


def sample_decode_failures(snappy_parts, sample_n=25):
    """Decompress a deterministic sample of ssz_snappy parts with the
    repo's own codec; returns [(path, error), ...]. Shared by the CLI and
    the committed-report staleness test so both derive the SAME verdict
    for a given tree."""
    if not snappy_parts or not sample_n:
        return []
    from consensus_specs_tpu_torch.utils.snappy import decompress

    sample = random.Random(7).sample(
        snappy_parts, min(sample_n, len(snappy_parts))
    )
    failures = []
    for path in sample:
        try:
            with open(path, "rb") as f:
                decompress(f.read())
        except Exception as e:
            failures.append((path, f"{type(e).__name__}: {e}"))
    return failures


def render_report(counts, incomplete, empty_cases, snappy_parts, ok):
    """The markdown report, tools/check_vectors.py's byte for byte.
    Deterministic for a given tree: no generation timestamp and no
    machine-local paths."""
    lines = [
        "# Vector sweep report",
        "",
        "Generated by `tools/check_vectors.py --report` "
        "(regenerate tree + report: `make sweep`).",
        "",
        "| preset | fork | runner | cases |",
        "|---|---|---|---|",
    ]
    lines += [
        f"| {p} | {f} | {r} | {n} |"
        for (p, f, r), n in sorted(counts.items())
    ]
    lines += [
        "",
        f"- total cases: **{sum(counts.values())}**",
        f"- INCOMPLETE sentinels: {len(incomplete)}",
        f"- empty case dirs: {len(empty_cases)}",
        f"- ssz_snappy parts: {len(snappy_parts)}",
        f"- verdict: **{'PASS' if ok else 'FAIL'}**",
        "",
    ]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("vectors_dir")
    ap.add_argument("--decode-sample", type=int, default=25,
                    help="ssz_snappy parts to decompress as a spot check")
    ap.add_argument("--report", default=None,
                    help="also write the table + verdict as markdown here")
    args = ap.parse_args()
    root = args.vectors_dir

    counts, incomplete, empty_cases, snappy_parts = scan_tree(root)

    print(f"{'preset':<9} {'fork':<13} {'runner':<18} cases")
    for (preset, fork, runner), n in sorted(counts.items()):
        print(f"{preset:<9} {fork:<13} {runner:<18} {n}")
    total = sum(counts.values())
    print(f"total cases: {total}")

    ok = True
    if incomplete:
        ok = False
        print(f"FAIL: {len(incomplete)} INCOMPLETE sentinel(s), e.g. {incomplete[:3]}")
    if empty_cases:
        ok = False
        print(f"FAIL: {len(empty_cases)} case dir(s) with no parts, e.g. {empty_cases[:3]}")
    if total == 0:
        ok = False
        print("FAIL: no cases found")

    if snappy_parts and args.decode_sample:
        failures = sample_decode_failures(snappy_parts, args.decode_sample)
        for path, err in failures:
            print(f"FAIL: {path}: {err}")
        n_sampled = min(args.decode_sample, len(snappy_parts))
        print(
            f"ssz_snappy spot check: {n_sampled - len(failures)}/{n_sampled} "
            "decode"
        )
        ok = ok and not failures

    if args.report:
        with open(args.report, "w") as f:
            f.write(render_report(counts, incomplete, empty_cases,
                                  snappy_parts, ok))
        print(f"report written: {args.report}")

    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
