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
                ``CONSENSUS_SPECS_TPU_TRACE``), with the fleet's
                cross-process stitching;
- ``slo``       declared latency objectives, multi-window burn rates
                over the histograms, and the fleet ``ShedPolicy`` (burn
                rates -> shed/drain decisions);
- ``snapshot``  the cross-process wire format: a worker's whole obs state
                (histograms, stats, gauges, flight journal, time series,
                spans) as one JSON-safe dict, merge-exact;
- ``fleet``     the ``FleetAggregator`` merging N worker snapshots into
                one exact fleet-wide metrics and journal surface;
- ``timeseries`` the bounded multi-resolution time-series store (opt-in,
                ``CONSENSUS_SPECS_TPU_TS``) with its exact merge;
- ``exposition`` the opt-in loopback HTTP endpoint: ``/metrics``,
                ``/snapshot``, ``/healthz``, ``/flightdump``,
                ``/timeseries``.

Stdlib only at import; ``ops`` modules are reached lazily at record time.
"""
from .exposition import ExpositionServer, start_exposition  # noqa: F401
from .tracing import (  # noqa: F401
    STAGES,
    Tracer,
    dump_trace,
    global_tracer,
    maybe_tracer,
    reset_global,
    trace_enabled,
)
