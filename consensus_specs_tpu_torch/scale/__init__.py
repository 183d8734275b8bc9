"""Mainnet-scale workload plane of the port (the counterpart of
consensus_specs_tpu/scale/).

Hierarchical aggregate-of-aggregates verification over a synthetic
million-validator registry:

- ``registry.py``  — deterministic seed -> millions of validators with
  real index-derived pubkeys and mainnet-preset committee shuffling
  (vectorized swap-or-not, bit-identical to the JAX package's registry
  and to ``spec.compute_committee``), emitted lazily as columnar numpy.
- ``pubkeys.py``   — memory-bounded pubkey plane: batched G1
  decompression through ``ops/codec.py`` on the card feeding a
  bytes-budgeted LRU over decompressed keys (``scale.pubkey_*`` gauges).
- ``hierarchy.py`` — per-committee aggregates verified via the RLC
  combine, committee verdicts folded up a slot-level tree so the slot
  pays ONE final exponentiation, with bisection localizing a bad
  committee exactly.
- ``routing.py``   — committee-affinity routing over the serve fleet
  (``CommitteeFleet``: a committee's sub-batches always reach the same
  worker, so its pubkey working set stays warm there).
- ``smoke.py``     — a small-but-mainnet-preset slot verified
  hierarchically == flat == host oracle over valid / censored / bad
  committee traffic, on the card, then routed through a 2-worker fleet
  by committee affinity.
"""
