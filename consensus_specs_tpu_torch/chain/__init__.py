"""Chain plane of the port (its copy of consensus_specs_tpu/chain/):
incremental proto-array fork choice behind the streaming verifier.

``proto_array``   the spec-agnostic incremental LMD-GHOST index (weight
                  deltas, one reverse sweep per batch, O(1) head);
``head_service``  gossip ingestion wired to the spec Store (oracle) and a
                  serve-plane ``VerificationService`` (signatures);
``metrics``       the ``chain.*`` observability family.
"""
from .head_service import HeadService
from .metrics import ChainMetrics
from .proto_array import ProtoArray, ProtoForkChoice

__all__ = [
    "HeadService",
    "ChainMetrics",
    "ProtoArray",
    "ProtoForkChoice",
]
