"""Altair spec tests, unit tests:
each ``test_*`` function of the JAX package's modules and its twin in
the port run in generator mode on every fork the case covers, and
their part lists must be equal part by part
(``consensus_specs_tpu_torch/test/harness.py``)."""
import pytest

from consensus_specs_tpu.test.altair.unittests import (
    test_config_invariants as jax_config_invariants,
    test_epoch_walks as jax_epoch_walks,
    test_light_client_proofs as jax_light_client_proofs,
    test_sync_protocol as jax_sync_protocol,
    test_validator as jax_validator,
)
from consensus_specs_tpu_torch.test.harness import (  # noqa: F401
    case_names,
    hold_case,
    paired_runs,
    port_harness,
)
from consensus_specs_tpu_torch.test.altair.unittests import (
    test_config_invariants as port_config_invariants,
    test_epoch_walks as port_epoch_walks,
    test_light_client_proofs as port_light_client_proofs,
    test_sync_protocol as port_sync_protocol,
    test_validator as port_validator,
)

MODULES = {
    "config_invariants": (jax_config_invariants, port_config_invariants),
    "epoch_walks": (jax_epoch_walks, port_epoch_walks),
    "light_client_proofs": (jax_light_client_proofs, port_light_client_proofs),
    "sync_protocol": (jax_sync_protocol, port_sync_protocol),
    "validator": (jax_validator, port_validator),
}


@pytest.mark.parametrize("key", sorted(MODULES))
def test_same_case_names(key):
    expected, port = MODULES[key]
    assert case_names(port) == case_names(expected)


@pytest.mark.parametrize("key,name,fork", paired_runs(MODULES))
def test_altair_case(key, name, fork):
    expected, port = MODULES[key]
    hold_case(getattr(expected, name), getattr(port, name), fork)
