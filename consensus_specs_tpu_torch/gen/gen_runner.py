"""Test-vector generator runner of the port (the counterpart of
consensus_specs_tpu/gen/gen_runner.py).

Own implementation of the reference's generator lifecycle
(reference gen_helpers/gen_base/gen_runner.py:41-235): per-case output dirs
``<preset>/<fork>/<runner>/<handler>/<suite>/<case>``, an ``INCOMPLETE``
sentinel written before case parts and removed after success (crash
containment + incremental regeneration), yaml + ssz_snappy part writers,
an error log that lets generation continue past failing cases, and slow-case
timing prints (>1s convention, reference gen_runner.py:26).

YAML parts are written by ``gen/yaml_writer.py``, which gives PyYAML's
``safe_dump(..., default_flow_style=None, sort_keys=False)`` text without
PyYAML, so the generators run where it is not installed.

CLI: ``main.py -o OUTPUT_DIR [-f] [-l preset ...] [-c]``.
"""
import argparse
import shutil
import sys
import time
from pathlib import Path

from ..utils.snappy import compress as snappy_compress
from .yaml_writer import dump as yaml_dump

INCOMPLETE = "INCOMPLETE"
ERROR_LOG = "testgen_error_log.txt"
SLOW_CASE_SECONDS = 1.0


def _yaml_dump(value) -> str:
    return yaml_dump(_plainify(value))


def _plainify(value):
    """YAML-friendly plain types: ints stay ints, bytes hex-prefixed,
    containers recursed."""
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return int(value)
    if isinstance(value, bytes):
        return "0x" + value.hex()
    if isinstance(value, str):
        return value
    if isinstance(value, dict):
        return {str(k): _plainify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plainify(v) for v in value]
    # SSZ views and other objects: encode via their serialization if present
    if hasattr(value, "encode_bytes"):
        return "0x" + value.encode_bytes().hex()
    return str(value)


def _write_part(case_dir: Path, name: str, kind: str, value) -> None:
    if kind == "ssz":
        data = value if isinstance(value, bytes) else value.encode_bytes()
        (case_dir / f"{name}.ssz_snappy").write_bytes(snappy_compress(data))
    elif kind == "bytes":
        (case_dir / f"{name}.ssz_snappy").write_bytes(snappy_compress(bytes(value)))
    elif kind in ("data", "cfg"):
        (case_dir / f"{name}.yaml").write_text(_yaml_dump(value))
    elif kind == "meta":
        # collected by the caller into meta.yaml
        raise AssertionError("meta parts are collected, not written directly")
    else:
        raise ValueError(f"unknown part kind {kind!r}")


def run_generator(generator_name: str, providers, args=None) -> int:
    parser = argparse.ArgumentParser(prog=f"gen-{generator_name}")
    parser.add_argument("-o", "--output-dir", required=True,
                        help="output directory for the vector tree")
    parser.add_argument("-f", "--force", action="store_true",
                        help="regenerate complete cases too")
    parser.add_argument("-l", "--preset-list", nargs="*", default=None,
                        help="limit generation to these presets")
    parser.add_argument("-c", "--collect-only", action="store_true",
                        help="list cases without generating")
    ns = parser.parse_args(args)

    output_dir = Path(ns.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    error_log = output_dir / ERROR_LOG

    generated = skipped = failed = collected = 0
    for provider in providers:
        provider.prepare()
        for case in provider.make_cases():
            if ns.preset_list is not None and case.preset_name not in ns.preset_list:
                continue
            collected += 1
            case_dir = (
                output_dir / case.preset_name / case.fork_name
                / case.runner_name / case.handler_name
                / case.suite_name / case.case_name
            )
            print(f"[{generator_name}] {case_dir.relative_to(output_dir)}")
            if ns.collect_only:
                continue
            incomplete = case_dir / INCOMPLETE
            if case_dir.exists() and not (incomplete.exists() or ns.force):
                skipped += 1
                continue  # complete from an earlier run (incremental regen)
            if case_dir.exists():
                shutil.rmtree(case_dir)
            case_dir.mkdir(parents=True)
            incomplete.touch()  # crash containment sentinel
            t0 = time.time()
            try:
                parts = case.case_fn()
                if parts is None:
                    # the test doesn't apply to this (fork, preset) — e.g.
                    # a with_presets/with_phases filter — not an error
                    shutil.rmtree(case_dir)
                    skipped += 1
                    continue
                meta = {}
                wrote = 0
                for (name, kind, value) in parts:
                    if kind == "meta":
                        meta[name] = _plainify(value)
                    else:
                        _write_part(case_dir, name, kind, value)
                        wrote += 1
                if meta:
                    (case_dir / "meta.yaml").write_text(_yaml_dump(meta))
                if wrote == 0 and not meta:
                    # unit-style test (asserts internally, yields no vector
                    # parts): an empty case dir is meaningless to client
                    # consumers — treat as filtered, not as a vector
                    shutil.rmtree(case_dir)
                    skipped += 1
                    continue
            except Exception as e:
                failed += 1
                with error_log.open("a") as f:
                    f.write(f"{case_dir}: {type(e).__name__}: {e}\n")
                print(f"  ERROR: {type(e).__name__}: {e}", file=sys.stderr)
                continue  # INCOMPLETE stays: the case regenerates next run
            except BaseException as e:
                # pytest.skip inside a decorator raises Skipped, which is NOT
                # an Exception subclass; treat it as a filtered case
                if type(e).__name__ == "Skipped":
                    shutil.rmtree(case_dir)
                    skipped += 1
                    continue
                raise
            incomplete.unlink()
            generated += 1
            dt = time.time() - t0
            if dt > SLOW_CASE_SECONDS:
                print(f"  (slow case: {dt:.1f}s)")

    print(
        f"[{generator_name}] collected={collected} generated={generated} "
        f"skipped={skipped} failed={failed}"
    )
    return 1 if failed else 0


def detect_incomplete(output_dir) -> list:
    """All case dirs still carrying the INCOMPLETE sentinel
    (reference Makefile:195-199)."""
    return sorted(str(p.parent) for p in Path(output_dir).rglob(INCOMPLETE))
