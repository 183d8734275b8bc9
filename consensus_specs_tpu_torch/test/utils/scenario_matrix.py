"""Scenario vocabulary + matrix for the code-generated `random` test trees.

Own design; capability parity with the reference's scenario machinery
(reference tests/generators/random/generate.py codegen over
test/utils/randomized_block_tests.py's vocabulary): randomized full
state-transition tests are ASSEMBLED from a small vocabulary —

  profiles:  how the pre-state is perturbed before the walk
  timings:   where inside an epoch the walk starts
  stressors: an extra pressure dimension (leak, churn, none)

— and the scenario MATRIX is the (pruned) cross product, rendered to real
pytest functions by ``tools/gen_random_tests.py`` (`make
generate_random_tests` regenerates; the emitted modules carry a DO NOT
EDIT banner). The spec's own asserts are the oracle: every composed block
must transition cleanly.

Each scenario ends with >= 2 block transitions (mirroring the reference's
BLOCK_TRANSITIONS_COUNT invariant) so every case exercises real blocks, not
just empty slot walks.
"""
from random import Random

from ..helpers.random import (
    randomize_balances,
    randomize_effective_balances,
    randomize_participation,
    run_random_scenario,
    slash_random_validators,
)
from ..helpers.state import next_epoch, next_slots


# -- vocabulary --------------------------------------------------------------

PROFILES = {
    "fresh": (),
    "shuffled_balances": ("balances", "effective"),
    "battle_scarred": ("balances", "effective", "participation", "slashings"),
}

TIMINGS = {
    "epoch_start": 0.0,
    "mid_epoch": 0.45,
    "epoch_tail": 0.92,
}

STRESSORS = ("calm", "leaking")

_MUTATORS = {
    "balances": randomize_balances,
    "effective": randomize_effective_balances,
    "participation": randomize_participation,
    "slashings": lambda spec, state, rng: slash_random_validators(
        spec, state, rng, fraction=0.08
    ),
}


def scenario_matrix():
    """The pruned cross product: every profile x timing, leaking only on
    the two perturbed profiles (a leaking fresh state adds nothing the
    calm fresh case does not cover) -> 15 scenarios per fork."""
    out = []
    for profile in PROFILES:
        for timing in TIMINGS:
            for stressor in STRESSORS:
                if stressor == "leaking" and profile == "fresh":
                    continue
                out.append((profile, timing, stressor))
    return out


def scenario_name(profile, timing, stressor):
    return f"random_{profile}_{timing}_{stressor}"


# -- runtime -----------------------------------------------------------------


def _apply_profile(spec, state, profile, rng):
    for key in PROFILES[profile]:
        _MUTATORS[key](spec, state, rng)


def _force_leak(spec, state):
    from ..helpers.state import advance_into_leak

    advance_into_leak(spec, state)


def run_matrix_scenario(spec, state, profile, timing, stressor, seed):
    """Execute one matrix cell as a sanity-blocks-format vector.

    Order matters: the leak (whole empty epochs) engages FIRST, then the
    intra-epoch timing offset is applied — otherwise every leaking cell
    would snap back to an epoch boundary and the timing dimension of the
    matrix would be illusory."""
    rng = Random(seed)
    # two epochs of history first, so attestations/exits have substance
    next_epoch(spec, state)
    next_epoch(spec, state)
    if stressor == "leaking":
        _force_leak(spec, state)
    offset = int(TIMINGS[timing] * int(spec.SLOTS_PER_EPOCH))
    if offset:
        next_slots(spec, state, offset)
    _apply_profile(spec, state, profile, rng)

    yield "pre", state

    walk = int(spec.SLOTS_PER_EPOCH) + rng.randrange(4)
    signed_blocks = run_random_scenario(spec, state, rng, slots=walk)
    while len(signed_blocks) < 2:  # the >=2-real-blocks invariant
        signed_blocks += run_random_scenario(spec, state, rng, slots=2)

    yield "blocks", signed_blocks
    yield "post", state
