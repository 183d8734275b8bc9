"""Phase0 spec tests on the merge fork, runs 2, 6, 10, ...: each
``test_*`` function of the phase0 modules (``tests/torch_phase0_modules.py``)
that ``with_all_phases`` also runs on merge, and its twin in the port, run
in generator mode on merge; their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu_torch.test import context
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    hold_case,
    paired_runs,
    port_harness,
)
from tests.torch_phase0_modules import MODULES
from tests.torch_threads import one_thread

one_thread()

FORK = context.MERGE


@pytest.mark.parametrize("key,name,fork",
                         paired_runs(MODULES, part=2, parts=4, fork=FORK))
def test_phase0_case_on_merge(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
