"""Light-client proof plane of the port (its copy of
consensus_specs_tpu/lightclient/).

The read-path product surface on the same engine: per-slot proof
artifacts (finality branch, next-sync-committee branch, assembled
``LightClientUpdate``) materialized once per ``(slot, state_root)`` and
served content-addressed to any number of read-only clients through a
deduplicating cache front (``ProofService``), with sync-committee
signatures verified through the existing ``VerificationService`` BLS
fast path (the port's, on the CUDA card unless its caller asks for
``device="cpu"``).

- ``proof_tree``: artifact construction + client-side verification
  (``build_update_artifact``, ``build_head_proof``, ``verify_artifact``).
- ``serve_proofs``: ``ProofService`` (bounded LRU + in-flight dedup,
  mirror of ``serve/cache.py`` semantics) + ``ProofMetrics``
  (``lightclient.*`` gauges, ``latency[proof_*]`` stages, flight plane).
- ``proof_smoke``: the 2-worker fleet smoke
  (``python -m consensus_specs_tpu_torch.lightclient.proof_smoke``).
"""
from .proof_tree import (  # noqa: F401
    FINALIZED_ROOT_GINDEX,
    NEXT_SYNC_COMMITTEE_GINDEX,
    ProofArtifact,
    ProofWorld,
    build_head_proof,
    build_update_artifact,
    proof_key,
    verify_artifact,
    verify_head_proof,
)
from .serve_proofs import ProofCache, ProofMetrics, ProofService  # noqa: F401
