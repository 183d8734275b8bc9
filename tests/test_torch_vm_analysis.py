"""The port's vmlint core (consensus_specs_tpu_torch/ops/vm_analysis.py)
against the JAX package's, on the CPU.

For every tier-1 registry program, built and analyzed in both packages at
the production assembly shape: the whole ``analyze_prog`` report (bounds,
pressure, cost, structure, findings), ``program_stats``,
``lowering_plan``, ``structural_plan`` (dedup on and off), the level
signatures, the detected period and the ``plan_structures`` decision are
equal dicts; ``tools/torch_vmlint.py --tier1`` passes against
VMLINT_BASELINE.json. (tests/test_torch_vm_analysis_rules.py has the
oracle and the rules.)
"""
import os
import subprocess
import sys

import pytest

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.ops import (  # noqa: E402
    vm_analysis as jva, vmlib as jvmlib,
)
from consensus_specs_tpu_torch.ops import vm_analysis, vmlib  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(w_mul=96, w_lin=192, pad_steps_to=256, pad_regs_to=64)
TIER1 = vm_analysis.registry_programs(tier1_only=True)


def test_registry_lists_equal_the_jax_package():
    assert vm_analysis.registry_programs(True) == jva.registry_programs(True)
    assert vm_analysis.registry_programs() == jva.registry_programs()
    assert set(vmlib.BUILDERS) == set(jvmlib.BUILDERS)


@pytest.mark.parametrize("key,kind,k,fold", TIER1, ids=[t[0] for t in TIER1])
def test_reports_and_plans_equal_the_jax_package(key, kind, k, fold):
    mine = vmlib.BUILDERS[kind](k, fold)
    ref = jvmlib.BUILDERS[kind](k, fold)
    report = vm_analysis.analyze_prog(mine, name=key, **SHAPE)
    assert report == jva.analyze_prog(ref, name=key, **SHAPE)
    assert report["errors"] == 0 and report["pressure"]["hazard"] is False

    # the instruction-tensor artifacts, on the programs analyze assembled
    a_mine = mine.assemble(annotate=False, **SHAPE)
    a_ref = ref.assemble(annotate=False, **SHAPE)
    assert vm_analysis.program_stats(a_mine) == jva.program_stats(a_ref)
    plan = vm_analysis.lowering_plan(a_mine)
    assert plan == jva.lowering_plan(a_ref)
    for dedup in (True, False):
        assert vm_analysis.structural_plan(plan, dedup=dedup) == \
            jva.structural_plan(plan, dedup=dedup)
    sigs = vm_analysis.level_signatures(plan)
    assert sigs == jva.level_signatures(plan)
    assert vm_analysis.detect_period(sigs) == jva.detect_period(sigs)
    got = vm_analysis.plan_structures(a_mine, vm_analysis.FUSED_CHUNK_STEPS)
    want = jva.plan_structures(a_ref, jva.FUSED_CHUNK_STEPS)
    assert got == want


def test_torch_vmlint_tier1_passes_against_the_committed_baseline():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_vmlint.py"),
         "--tier1"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "9 program(s), 0 failure(s)" in res.stdout
    assert "consensus_specs_tpu." not in res.stderr


def test_baseline_path_is_the_repo_file():
    assert vm_analysis.BASELINE_PATH == jva.BASELINE_PATH
    assert vm_analysis.load_baseline() == jva.load_baseline()
