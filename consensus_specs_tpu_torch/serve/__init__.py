"""Serve plane of the port: continuous micro-batching ingress for the
port's BLS backend (the counterpart of consensus_specs_tpu/serve/).

Bounded ingress queue -> micro-batches (flush on size OR deadline) -> ONE
RLC combined check per flush (batch_verify_rlc; CONSENSUS_SPECS_TPU_RLC=0
reverts to (kind, K-bucket) grouped batched calls, the fallback ladder
either way ending at the pure-Python oracle) -> content-keyed result cache
and in-flight dedup. See service.py for the dataflow and its CUDA streams.

The fleet tier promotes this plane to N worker PROCESSES:
``fleet.FleetRouter`` spawns one ``worker.py`` service process per worker
(each with its own CUDA context on the card), routes by consistent-hash
content key, merges every worker's observability snapshot into one
``/metrics`` surface (``obs/fleet.py``), and sheds load down the RLC ->
per-group -> oracle ladder from SLO burn rates on the MERGED histograms.
"""
from .cache import ResultCache, check_key  # noqa: F401
from .fleet import FleetRouter, HashRing, WorkerHandle  # noqa: F401
from .metrics import ServeMetrics  # noqa: F401
from .service import (  # noqa: F401
    QueueFull,
    ServiceClosed,
    SlotClock,
    VerificationService,
)
