"""Opt-in metrics exposition endpoint (the port's copy of
consensus_specs_tpu/obs/exposition.py; stdlib ``http.server``, daemon
threads).

Routes:
  ``/metrics``    Prometheus text format 0.0.4 (``obs/registry.py`` renders
                  the live profiling snapshot, latency histograms
                  included);
  ``/snapshot``   the wired ``ServeMetrics.snapshot()`` JSON (or the
                  profiling summary when no service is attached);
  ``/healthz``    liveness AND objective state: the SLO tracker's
                  evaluation (``obs/slo.py``) with a top-level ``ok`` that
                  is the AND over declared objectives;
  ``/flightdump`` the flight recorder's journal as JSONL
                  (``obs/flight.py``; 404 when the recorder is disabled);
  ``/timeseries`` the rendered time-series rings (``obs/timeseries.py``;
                  404 when disabled).
The fleet router overrides each route's body with its aggregator's exact
cross-worker merge.

Opt-in: nothing binds a port unless ``start_exposition`` is called (the
serve bench does when ``SERVE_METRICS_PORT`` is set). ``port=0`` binds an
ephemeral port; read it back from ``server.port``. It binds loopback by
default. Scrapes read shared accumulators under the writers' locks, and a
handler exception answers 500, never kills the daemon thread.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import registry


def _default_snapshot():
    from ..ops import profiling

    return {"profile": profiling.summary()}


class _Handler(BaseHTTPRequestHandler):
    server_version = "consensus-specs-tpu-obs/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                # a metrics_fn override swaps the body source (the fleet
                # router serves its aggregator's MERGED cross-process
                # render here); the default is this process's registry
                fn = self.server.metrics_fn
                body = (fn() if fn is not None
                        else registry.render_prometheus()).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/snapshot":
                body = json.dumps(self.server.snapshot_fn(),
                                  sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/healthz":
                fn = self.server.healthz_fn
                if fn is not None:
                    payload = fn()
                else:
                    from . import slo

                    payload = slo.global_tracker().healthz()
                body = json.dumps(payload, sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/flightdump":
                fn = self.server.flight_fn
                if fn is not None:
                    body = fn().encode()
                else:
                    from . import flight

                    rec = flight.maybe_recorder()
                    if rec is None:
                        self.send_error(
                            404, "flight recorder disabled "
                            "(set CONSENSUS_SPECS_TPU_FLIGHT=1)")
                        return
                    body = rec.to_jsonl(
                        reason="flightdump_endpoint").encode()
                ctype = "application/x-ndjson"
            elif path == "/timeseries":
                fn = self.server.timeseries_fn
                if fn is not None:
                    payload = fn()
                else:
                    from . import timeseries

                    store = timeseries.maybe_store()
                    if store is None:
                        self.send_error(
                            404, "timeseries disabled "
                            "(set CONSENSUS_SPECS_TPU_TS=1)")
                        return
                    payload = store.render()
                body = json.dumps(payload, sort_keys=True).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown path")
                return
        except Exception as e:  # a broken scrape must answer, not die
            try:
                self.send_error(500, f"{type(e).__name__}: {e}"[:200])
            except Exception:
                pass
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # no stderr line per scrape
        pass


class ExpositionServer:
    """A bound-and-serving exposition endpoint on a daemon thread."""

    def __init__(self, snapshot_fn=None, host: str = "127.0.0.1",
                 port: int = 0, metrics_fn=None, healthz_fn=None,
                 flight_fn=None, timeseries_fn=None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.snapshot_fn = snapshot_fn or _default_snapshot
        # per-route body overrides (None = this process's default source);
        # the fleet router passes its aggregator's merged render/healthz/
        # journal/timeseries so ONE endpoint class serves both shapes
        self._httpd.metrics_fn = metrics_fn
        self._httpd.healthz_fn = healthz_fn
        self._httpd.flight_fn = flight_fn
        self._httpd.timeseries_fn = timeseries_fn
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-exposition",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def url(self, path: str = "/metrics") -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}{path}"

    def close(self, timeout: float = 5.0) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_exposition(metrics=None, snapshot_fn=None, host: str = "127.0.0.1",
                     port: int = 0, metrics_fn=None, healthz_fn=None,
                     flight_fn=None, timeseries_fn=None) -> ExpositionServer:
    """Start the endpoint. ``metrics`` is a ``ServeMetrics`` (its
    ``snapshot`` becomes ``/snapshot``); ``snapshot_fn`` overrides; with
    neither, ``/snapshot`` serves the profiling summary. The ``*_fn``
    overrides swap a route's body source (fleet-merged rendering)."""
    if snapshot_fn is None and metrics is not None:
        snapshot_fn = metrics.snapshot
    return ExpositionServer(snapshot_fn=snapshot_fn, host=host, port=port,
                            metrics_fn=metrics_fn, healthz_fn=healthz_fn,
                            flight_fn=flight_fn, timeseries_fn=timeseries_fn)
