"""Host Merkleization plane of the port (its copy of
consensus_specs_tpu/merkle/).

Layers, bottom up:

- ``levels``  — the batched level hasher + the
  ``CONSENSUS_SPECS_TPU_MERKLE=native|python|auto`` mode knob, the
  ``merkle.*`` counters, and the diff-gate switches. stdlib-only import.
- ``cache``   — ``LevelTree``: the incremental layer cache with batched
  dirty-set updates (aliased as ``ssz_typing._ChunkTree``).
- ``plane``   — cross-element column-batched cold roots for statically
  shaped series elements (imports the SSZ engine: LAZY import only from
  within ``ssz_typing``).

``plane`` is deliberately NOT imported here: ssz_typing
imports ``merkle.levels``/``merkle.cache`` at its own import time, and
pulling ``plane`` (which imports ssz_typing back) into the package
import would cycle.
"""
from . import cache, levels  # noqa: F401
from .cache import LevelTree  # noqa: F401
