"""Observability plane of the port: the counterpart of
consensus_specs_tpu/obs/ for what the serve plane and the VM executor
record.

- ``hist``      mergeable log-bucketed histograms, the latency metric
                type behind ``ops/profiling``;
- ``registry``  the metric-name registry and the Prometheus renderer;
- ``latency``   per-stage serve-pipeline histograms and the downstream
                p99 the deadline-aware flush reads;
- ``flight``    the flight recorder (opt-in, ``CONSENSUS_SPECS_TPU_FLIGHT``);
- ``devices``   the per-device occupancy ledger (CUDA device index lanes
                plus the ``host`` prep lane);
- ``programs``  the per-program VM registry;
- ``tracing``   per-request spans and the Chrome trace export (opt-in,
                ``CONSENSUS_SPECS_TPU_TRACE``).

Stdlib only at import; ``ops`` modules are reached lazily at record time.
"""
