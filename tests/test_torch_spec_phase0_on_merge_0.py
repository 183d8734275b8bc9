"""Phase0 spec tests on the merge fork, runs 0, 4, 8, ...: each
``test_*`` function of the phase0 modules (``tests/torch_phase0_modules.py``)
that ``with_all_phases`` also runs on merge, and its twin in the port, run
in generator mode on merge; their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu_torch.test import context
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    covered_forks,
    hold_case,
    paired_cases,
    paired_runs,
    port_harness,
)
from tests.torch_phase0_modules import MODULES, RUNS_ON_LATER_FORK
from tests.torch_threads import one_thread

one_thread()

FORK = context.MERGE


def test_runs_on_merge_are_all_counted():
    """Exactly RUNS_ON_LATER_FORK cases run on merge (a case dropping out
    of ``covered_forks`` fails here), and each port case covers the
    forks its JAX twin covers."""
    assert len(paired_runs(MODULES, fork=FORK)) == RUNS_ON_LATER_FORK
    for key, name in paired_cases(MODULES):
        expected, port = MODULES[key]
        assert covered_forks(getattr(port, name)) == \
            covered_forks(getattr(expected, name)), (key, name)


@pytest.mark.parametrize("key,name,fork",
                         paired_runs(MODULES, part=0, parts=4, fork=FORK))
def test_phase0_case_on_merge(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
