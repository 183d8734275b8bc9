"""The port's serve plane on a mesh (the mirror of tests/test_mesh_rlc.py's
serve cases): a mesh failure costs one fallback and a
``degraded_mesh_to_single`` flight event, never the flush; a clean mesh
flush takes no fallback; a flush narrower than the mesh runs on the
single-device path; a 1-slot mesh collapses to the unsharded path; the
mesh provider arms the service through CONSENSUS_SPECS_TPU_MESH; and the
sweep's line parser takes a child's last JSON line. Each case runs the
port's service (on a CPU ``torch_env.Mesh``) and the JAX package's (on
the JAX-style shape stub its own tests use) on the same crypto-free
backend."""
import types

import pytest
from tests.torch_threads import one_thread

from consensus_specs_tpu.obs import flight as jflight
from consensus_specs_tpu.serve.load import \
    _parse_last_json_line as jax_parse
from consensus_specs_tpu.serve.service import \
    VerificationService as JaxService
from consensus_specs_tpu_torch.obs import flight
from consensus_specs_tpu_torch.serve.load import _parse_last_json_line
from consensus_specs_tpu_torch.serve.service import VerificationService
from consensus_specs_tpu_torch.utils import torch_env

one_thread()

FLIGHT = "CONSENSUS_SPECS_TPU_FLIGHT"


class _MeshBackend:
    """Records whether calls arrived sharded; raises on the mesh path when
    ``explode`` (the serve rung's fault injection). Takes ``device=`` as
    the port's service passes it."""

    def __init__(self, explode: bool):
        self.explode = explode
        self.mesh_calls = 0
        self.plain_calls = 0

    def _route(self, mesh):
        if mesh is not None:
            self.mesh_calls += 1
            if self.explode:
                raise RuntimeError("injected mesh failure")
        else:
            self.plain_calls += 1

    def batch_verify_rlc(self, items, mesh=None, device=None):
        self._route(mesh)
        return [bytes(sig) != b"\xba" * 96 for (_k, _p, _m, sig) in items]

    def batch_fast_aggregate_verify(self, pks, msgs, sigs, mesh=None,
                                    device=None):
        self._route(mesh)
        return [bytes(sig) != b"\xba" * 96 for sig in sigs]


def _mesh(svc_cls, n_dev: int):
    """The port's service gets a real CPU mesh, the JAX package's a stub
    with a JAX-style ``shape``."""
    if svc_cls is VerificationService:
        return torch_env.make_mesh(n_dev, "cpu")
    return types.SimpleNamespace(shape={"batch": n_dev})


def _serve_items(n=3):
    out = []
    for i in range(n):
        sig = b"\xba" * 96 if i == n - 1 else bytes([i + 1]) * 96
        out.append(("fast_aggregate", [b"\x01" * 48],
                    b"%02d" % i + b"m" * 30, sig))
    return out


def _run(svc_cls, mesh, explode, items, **kw):
    be = _MeshBackend(explode=explode)
    kw = dict(kw)
    if svc_cls is VerificationService:
        kw["device"] = "cpu"
    svc = svc_cls(backend=be, mesh=mesh, **kw)
    try:
        futures = [svc.submit(*it) for it in items]
        got = [f.result(timeout=30) for f in futures]
    finally:
        svc.close(timeout=30)
    return svc, be, got


@pytest.mark.parametrize("svc_cls", [VerificationService, JaxService],
                         ids=["port", "jax"])
def test_serve_mesh_fallback_rung(svc_cls, monkeypatch):
    monkeypatch.setenv(FLIGHT, "1")
    rec_mod = flight if svc_cls is VerificationService else jflight
    rec_mod.reset_global()
    try:
        svc, be, got = _run(svc_cls, _mesh(svc_cls, 2), True, _serve_items(),
                            max_wait_ms=200.0)
        kinds = [e["kind"] for e in rec_mod.global_recorder().events()]
    finally:
        rec_mod.reset_global()
    assert got == [True, True, False]
    assert be.mesh_calls >= 1 and be.plain_calls >= 1
    snap = svc.metrics.snapshot()
    assert snap["mesh_devices"] == 2
    assert snap["mesh_fallbacks"] == be.mesh_calls
    assert "degraded_mesh_to_single" in kinds


@pytest.mark.parametrize("svc_cls", [VerificationService, JaxService],
                         ids=["port", "jax"])
def test_serve_mesh_success_no_fallback(svc_cls):
    svc, be, got = _run(svc_cls, _mesh(svc_cls, 2), False, _serve_items(),
                        max_wait_ms=200.0)
    assert got == [True, True, False]
    assert be.mesh_calls >= 1 and be.plain_calls == 0
    assert svc.metrics.mesh_fallbacks == 0
    assert svc.mesh_devices == 2


@pytest.mark.parametrize("svc_cls", [VerificationService, JaxService],
                         ids=["port", "jax"])
def test_serve_narrow_flush_stays_single_device(svc_cls):
    svc, be, got = _run(svc_cls, _mesh(svc_cls, 4), True, _serve_items(2),
                        max_wait_ms=200.0)
    assert got == [True, False]
    assert be.mesh_calls == 0 and be.plain_calls >= 1
    assert svc.metrics.mesh_fallbacks == 0
    assert svc.mesh_devices == 4


@pytest.mark.parametrize("svc_cls", [VerificationService, JaxService],
                         ids=["port", "jax"])
def test_serve_single_slot_mesh_collapses_to_unsharded(svc_cls):
    svc, be, got = _run(svc_cls, _mesh(svc_cls, 1), False, _serve_items(2)[:1],
                        max_wait_ms=5.0)
    assert got == [True]
    assert svc.mesh_devices == 0
    assert be.mesh_calls == 0 and be.plain_calls >= 1


def test_serve_group_attempt_zero_rides_the_mesh(monkeypatch):
    """With the RLC path off, a group's first attempt runs on the mesh and
    a failure there costs one mesh fallback before the single-device
    retry answers."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC", "0")
    svc, be, got = _run(VerificationService, _mesh(VerificationService, 2), True,
                        _serve_items(), max_wait_ms=200.0)
    assert got == [True, True, False]
    assert be.mesh_calls == 1 and be.plain_calls >= 1
    assert svc.metrics.mesh_fallbacks == 1


def test_service_takes_its_mesh_from_the_env(monkeypatch):
    """Without ``mesh=`` the service asks ``torch_env.maybe_mesh`` for its
    device: CONSENSUS_SPECS_TPU_MESH=4 on the CPU gives a 4-slot mesh."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_MESH", "4")
    svc, be, got = _run(VerificationService, None, False, _serve_items(4),
                        max_wait_ms=200.0)
    assert got == [True, True, True, False]
    assert svc.mesh_devices == 4 and be.mesh_calls >= 1
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_MESH", "off")
    svc, be, _ = _run(VerificationService, None, False, _serve_items(2),
                      max_wait_ms=5.0)
    assert svc.mesh_devices == 0 and be.mesh_calls == 0


@pytest.mark.parametrize("out,want", [
    (b'warming up...\n{"value": 1}\nnoise\n{"value": 2, "mode": "serve"}\n',
     {"value": 2, "mode": "serve"}),
    (b"no json here\n", None),
    (b"", None),
])
def test_mesh_sweep_line_parser(out, want):
    assert _parse_last_json_line(out) == jax_parse(out) == want
