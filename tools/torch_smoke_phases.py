#!/usr/bin/env python3
"""Run named phases of chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/torch_smoke_phases.py lightclient sim spec_tests gen bench
    python3 tools/torch_smoke_phases.py vmexec twins finalexp mesh
    python3 tools/torch_smoke_phases.py --no-kernels kzg forks lightclient
    python3 tools/torch_smoke_phases.py wide_aggregate

Builds the port's kernels (chip_smoke's build), then runs each named phase
that needs no earlier phase's output (``kzg``, ``forks``,
``lightclient``, ``sim``, ``spec_tests``, ``gen``, ``bench``, ``vmexec``,
``twins``, ``finalexp``, ``mesh`` and ``wide_aggregate``; the first three
and the last with a key pool of their own; ``wide_aggregate`` starts its
programs' cold builds first and waits for them), each printing
chip_smoke's JSON line for it, with every (program,
rows) the phase launched the step kernel at noted, and last the
``kernels`` line that holds each such shape's first 256 steps against the
plain steps (max |err| 0 required) and times the whole stream, as
chip_smoke's last phase does, with each phase's launches of every kernel
(the tower kernels of ops/cuda_tower.py counted from 0 at each phase;
``twins`` and ``mesh`` hold them against their plain versions and time
them, as in the whole smoke); ``--no-kernels`` leaves that line out, to
time the phases alone. Programs are assembled
cold (nothing earlier ran), so a phase's first card calls take longer
than inside the whole smoke. Exit 0 when every phase passed.
"""
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run alone, wide_aggregate waits for its builds with no phase beside them
WIDE_AGG_ALONE_DEADLINE_S = 1800.0


def main(names):
    import torch

    kernels_line = "--no-kernels" not in names
    names = [n for n in names if n != "--no-kernels"]

    if not torch.cuda.is_available():
        print("torch_smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_build, vm
    from consensus_specs_tpu_torch.utils.keygen import KeyPool

    phases = ("kzg", "forks", "lightclient", "sim", "spec_tests", "gen",
              "bench", "vmexec", "twins", "finalexp", "mesh",
              "wide_aggregate")
    unknown = [n for n in names if n not in phases]
    if unknown or not names:
        print(f"torch_smoke_phases: phases are {', '.join(phases)}, "
              f"not {unknown or names}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name, power = (s.strip() for s in
                   cs._nvidia_smi("name,power.limit").split(","))
    card = {"card": name, "power_limit": power}
    props = torch.cuda.get_device_properties(0)
    sm_clock_mhz = float(cs._nvidia_smi("clocks.max.sm").split()[0])
    imad_rate = props.multi_processor_count * cs.IMAD_PER_SM_CLOCK \
        * sm_clock_mhz * 1e6
    l2_ns = cs.L2_HIT_CYCLES / sm_clock_mhz * 1e3
    rng = np.random.default_rng(cs.SEED)
    t0 = time.perf_counter()
    # the wide AggregateVerify programs' cold builds start first, as in
    # the whole smoke
    builds = cs._WideBuilds() if "wide_aggregate" in names else None
    try:
        reports = cuda_build.build()
        cs._emit({"phase": "build", "compiled": sorted(reports),
                  "build_s": time.perf_counter() - t0, **card})
        path_shapes, launches = {}, {}
        for phase in names:
            cs._tower_reset()
            if phase == "twins":
                line, launches[phase], _ = cs.phase_twins(
                    torch, dev, rng, imad_rate, card)
                cs._tower_into(launches[phase])
                cs._emit({**line, "elapsed_s": time.perf_counter() - t0})
                continue
            if phase in ("sim", "vmexec"):
                run = cs.phase_sim if phase == "sim" else cs.phase_vmexec
                line, launches[phase] = run(torch, card)
                cs._tower_into(launches[phase])
                cs._emit({**line, "elapsed_s": time.perf_counter() - t0})
                continue
            shapes = path_shapes[phase] = {}
            program_wrap, execute_wrap = cs._recording_launch_shapes(shapes)
            if phase == "bench":
                with cs._patched(bls_backend, "_program", program_wrap), \
                        cs._patched(vm, "execute", execute_wrap):
                    line, launches[phase] = cs.phase_bench(torch, card,
                                                           shapes)
                cs._tower_into(launches[phase])
                cs._emit({**line, "elapsed_s": time.perf_counter() - t0})
                continue
            if phase == "wide_aggregate":
                with KeyPool() as pool:
                    inputs = cs.wide_aggregate_inputs(pool)
                with cs._patched(bls_backend, "_program", program_wrap), \
                        cs._patched(vm, "execute", execute_wrap):
                    line, launches[phase] = cs.phase_wide_aggregate(
                        torch, card, inputs, builds,
                        deadline_s=WIDE_AGG_ALONE_DEADLINE_S)
                line["new_shapes"] = cs.new_launch_shapes(path_shapes, phase,
                                                          [])
                cs._tower_into(launches[phase])
                cs._emit({**line, "elapsed_s": time.perf_counter() - t0})
                continue
            if phase in ("spec_tests", "gen", "finalexp", "mesh"):
                run = {"spec_tests": cs.phase_spec_tests,
                       "gen": cs.phase_gen,
                       "finalexp": cs.phase_finalexp,
                       "mesh": cs.phase_mesh}[phase]
                with cs._patched(bls_backend, "_program", program_wrap), \
                        cs._patched(vm, "execute", execute_wrap):
                    line, launches[phase] = run(torch, card)
                line["new_shapes"] = cs.new_launch_shapes(path_shapes, phase,
                                                          [])
                cs._tower_into(launches[phase])
                cs._emit({**line, "elapsed_s": time.perf_counter() - t0})
                continue
            with KeyPool() as pool, \
                    cs._patched(bls_backend, "_program", program_wrap), \
                    cs._patched(vm, "execute", execute_wrap):
                if phase in ("kzg", "forks"):
                    run = cs.phase_kzg if phase == "kzg" else cs.phase_forks
                    line, launches[phase] = run(torch, pool, card)
                    smoke_shapes = {}
                else:
                    line, launches[phase], smoke_shapes = \
                        cs.phase_lightclient(torch, pool, card)
            for key, shape in smoke_shapes.items():
                shapes.setdefault(key, shape)
            cs._tower_into(launches[phase])
            cs._emit({**line, "elapsed_s": time.perf_counter() - t0})
        if not kernels_line:
            print(json.dumps({"ok": True, "phases": names}))
            return 0
        streams = cs.phase_path_streams(torch, dev, rng, imad_rate, l2_ns,
                                        path_shapes, [])
        cs._emit({"phase": "kernels", "paths": list(path_shapes),
                  "shapes_launched": {p: len(s)
                                      for p, s in path_shapes.items()},
                  "results": streams, "launches_by_path": launches,
                  "elapsed_s": time.perf_counter() - t0, **card})
    except cs.SmokeFailure as e:
        print(f"torch_smoke_phases: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if builds is not None:
            builds.stop()
    print(json.dumps({"ok": True, "phases": names}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
