"""Workload builders of the port (counterparts of
consensus_specs_tpu/bench/)."""
