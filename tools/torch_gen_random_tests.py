"""Code-generate the port's `random` scenario-matrix test modules (the
counterpart of tools/gen_random_tests.py).

Role parity with the reference's random test codegen (reference
tests/generators/random/generate.py writes test_random.py files from a
scenario matrix because the test infra cannot synthesize pytest-visible
cases dynamically — same constraint here). Run from the repo root:

    python tools/torch_gen_random_tests.py

Scenario vocabulary/matrix:
consensus_specs_tpu_torch/test/utils/scenario_matrix.py. The output is
the JAX package's modules with this tool named in the header.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from consensus_specs_tpu_torch.test.utils.scenario_matrix import (  # noqa: E402
    scenario_matrix,
    scenario_name,
)

_HEADER = '''"""Code-generated randomized scenario-matrix tests — DO NOT EDIT.

Regenerate with `python tools/torch_gen_random_tests.py`; the
vocabulary/matrix lives in test/utils/scenario_matrix.py. Mirrors the
reference's code-generated random suites (reference
tests/generators/random/generate.py)."""
from ...context import {fork_const}, spec_state_test, with_phases
from ...utils.scenario_matrix import run_matrix_scenario

'''

_CASE = '''
@with_phases([{fork_const}])
@spec_state_test
def test_{name}(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile={profile!r}, timing={timing!r}, stressor={stressor!r},
        seed={seed},
    )

'''

_TARGETS = {
    "phase0": ("PHASE0",
               "consensus_specs_tpu_torch/test/phase0/random/test_random_matrix.py"),
    "altair": ("ALTAIR",
               "consensus_specs_tpu_torch/test/altair/random/test_random_matrix.py"),
}


def render(fork: str) -> str:
    fork_const, _ = _TARGETS[fork]
    parts = [_HEADER.format(fork_const=fork_const)]
    for i, (profile, timing, stressor) in enumerate(scenario_matrix()):
        parts.append(_CASE.format(
            fork_const=fork_const,
            name=scenario_name(profile, timing, stressor),
            profile=profile, timing=timing, stressor=stressor,
            # distinct deterministic seed per (fork, cell)
            seed=10_000 * (1 + list(_TARGETS).index(fork)) + i,
        ))
    return "".join(parts)


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for fork, (_, rel) in _TARGETS.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        init = os.path.join(os.path.dirname(path), "__init__.py")
        if not os.path.exists(init):
            open(init, "w").close()
        with open(path, "w") as f:
            f.write(render(fork))
        print(f"wrote {rel} ({len(scenario_matrix())} cases)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
