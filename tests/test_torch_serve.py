"""The port's serve plane (consensus_specs_tpu_torch/serve/) against the
JAX package's, on the CPU.

Each case of tests/test_serve.py runs on both services with the same
crypto-free test doubles, as one test parametrised over the package;
where the flush composition is deterministic (``max_wait_ms`` large) the
counters are held to the same values, and one test compares them
directly. Then the real-backend case at tests/test_serve.py's shapes (two
committees of k=2, RLC chunks of 2): the port's service on the port's
backend with ``device="cpu"`` against the JAX service on the JAX backend,
equal verdicts, CALL_COUNTS and RLC_STATS deltas; and both packages'
``run_serve_bench`` at a tiny size with the injected failure on.
"""
import json
import random
import time

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import pytest  # noqa: E402

from consensus_specs_tpu import serve as jserve  # noqa: E402
from consensus_specs_tpu.ops import bls_backend as jbls  # noqa: E402
from consensus_specs_tpu.ops import profiling as jprofiling  # noqa: E402
from consensus_specs_tpu.utils import bls as jbls_api  # noqa: E402
from consensus_specs_tpu.utils.bls12_381 import R  # noqa: E402
from consensus_specs_tpu_torch import serve as tserve  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend as tbls  # noqa: E402
from consensus_specs_tpu_torch.ops import profiling as tprofiling  # noqa: E402
from consensus_specs_tpu_torch.utils import bls as tbls_api  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

PK = b"\x01" * 48  # plumbing tests never decode keys; any bytes serve
PKGS = ("jax", "torch")


class Pkg:
    """One package's serve surface, service kwargs and modules."""

    def __init__(self, name):
        self.name = name
        self.serve = jserve if name == "jax" else tserve
        self.bls = jbls_api if name == "jax" else tbls_api
        self.backend = jbls if name == "jax" else tbls
        self.profiling = jprofiling if name == "jax" else tprofiling
        # the port resolves its device at construction: the CPU here
        self.kw = {} if name == "jax" else {"device": "cpu"}

    def service(self, backend=None, **kw):
        return self.serve.VerificationService(backend=backend,
                                              **{**self.kw, **kw})


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture(autouse=True)
def _bls_on():
    was = (jbls_api.bls_active, tbls_api.bls_active, tbls_api._backend)
    jbls_api.bls_active = tbls_api.bls_active = True
    # the port's switchboard defaults to the card: the test doubles that
    # call it ask for the CPU oracle, as the JAX switchboard's default is
    tbls_api.use_py_ecc()
    jprofiling.reset()
    tprofiling.reset()
    yield
    jbls_api.bls_active, tbls_api.bls_active, tbls_api._backend = was


class CountingBackend:
    """Crypto-free batched backend: an item verifies True iff its
    signature ends with b"ok". Counts entry-point calls and items. Has NO
    batch_verify_rlc: the service must take the per-group path. Accepts
    either package's keyword arguments (``mesh`` / ``device``)."""

    def __init__(self, delay_s=0.0, fail_always=False, fail_calls=()):
        self.calls = 0
        self.items = 0
        self.rlc_calls = 0
        self.delay_s = delay_s
        self.fail_always = fail_always
        self.fail_calls = set(fail_calls)

    def _go(self, signatures):
        self.calls += 1
        if self.fail_always or self.calls in self.fail_calls:
            raise RuntimeError(f"injected backend failure (call {self.calls})")
        if self.delay_s:
            time.sleep(self.delay_s)
        self.items += len(signatures)
        return np.array([s.endswith(b"ok") for s in signatures], dtype=bool)

    def batch_fast_aggregate_verify(self, pubkey_sets, messages, signatures,
                                    **kw):
        return self._go(signatures)

    def batch_aggregate_verify(self, pubkey_lists, message_lists, signatures,
                               **kw):
        return self._go(signatures)


class OracleBackend(CountingBackend):
    """Batched entry points that resolve each item through ``bls``'s
    pure-Python oracle, with the call ledger."""

    def __init__(self, bls):
        super().__init__()
        self.bls = bls

    def _verdicts(self, items):
        self.calls += 1
        self.items += len(items)
        return np.array(
            [self.bls.FastAggregateVerify(pks, msgs, sig)
             if kind == "fast_aggregate"
             else self.bls.AggregateVerify(pks, msgs, sig)
             for kind, pks, msgs, sig in items], dtype=bool)

    def batch_fast_aggregate_verify(self, pubkey_sets, messages, signatures,
                                    **kw):
        return self._verdicts([("fast_aggregate", p, m, s) for p, m, s
                               in zip(pubkey_sets, messages, signatures)])

    def batch_aggregate_verify(self, pubkey_lists, message_lists, signatures,
                               **kw):
        return self._verdicts([("aggregate", p, m, s) for p, m, s
                               in zip(pubkey_lists, message_lists, signatures)])

    def batch_verify_rlc(self, items, **kw):
        self.rlc_calls += 1
        return self._verdicts(items)


class CountingOracle:
    """verify_one fallback with the signature-suffix truth rule."""

    def __init__(self):
        self.calls = 0

    def verify_one(self, pending):
        self.calls += 1
        return bytes(pending.signature).endswith(b"ok")


def _svc(pkg, backend, **kw):
    kw.setdefault("bucket_fn", lambda k: 8)
    kw.setdefault("oracle", CountingOracle())
    return pkg.service(backend, **kw)


def _counters(svc):
    m = svc.metrics
    return {k: getattr(m, k) for k in (
        "cache_hits", "inflight_joins", "fallback_items", "backend_retries",
        "batches", "rows_filled", "submits", "eager")}


# -- flush triggers ---------------------------------------------------------


def test_size_triggered_flush(pkg):
    be = CountingBackend()
    with _svc(pkg, be, max_batch=4, max_wait_ms=10_000) as svc:
        futs = [svc.submit("fast_aggregate", [PK], b"m%d" % i, b"s%d-ok" % i)
                for i in range(4)]
        assert [f.result(timeout=5) for f in futs] == [True] * 4
    assert be.calls == 1 and be.items == 4
    assert svc.metrics.batches == 1 and svc.metrics.rows_filled == 4


def test_deadline_triggered_flush(pkg):
    be = CountingBackend()
    with _svc(pkg, be, max_batch=1000, max_wait_ms=30) as svc:
        f1 = svc.submit("fast_aggregate", [PK], b"m1", b"a-ok")
        f2 = svc.submit("fast_aggregate", [PK], b"m2", b"b-bad")
        assert f1.result(timeout=5) is True
        assert f2.result(timeout=5) is False
    assert svc.metrics.batches >= 1 and svc.metrics.rows_filled == 2


def test_shutdown_drain_resolves_everything(pkg):
    be = CountingBackend()
    svc = _svc(pkg, be, max_batch=1000, max_wait_ms=600_000)
    futs = [svc.submit("fast_aggregate", [PK], b"m%d" % i, b"s%d-ok" % i)
            for i in range(5)]
    svc.close(timeout=30)  # neither trigger fired: close must drain
    assert all(f.done() for f in futs)
    assert [f.result() for f in futs] == [True] * 5
    assert be.items == 5


def test_submit_after_close_raises(pkg):
    svc = _svc(pkg, CountingBackend())
    svc.close(timeout=30)
    with pytest.raises(pkg.serve.ServiceClosed):
        svc.submit("fast_aggregate", [PK], b"m", b"s-ok")


# -- cache + dedup ----------------------------------------------------------


def test_inflight_join_and_cache_hit_verify_once(pkg):
    be = CountingBackend(delay_s=0.2)
    with _svc(pkg, be, max_batch=1, max_wait_ms=0) as svc:
        f1 = svc.submit("fast_aggregate", [PK], b"dup", b"sig-ok")
        f2 = svc.submit("fast_aggregate", [PK], b"dup", b"sig-ok")
        assert f2 is f1
        assert f1.result(timeout=10) is True
        f3 = svc.submit("fast_aggregate", [PK], b"dup", b"sig-ok")
        assert f3.done() and f3.result() is True
    assert be.items == 1
    assert svc.metrics.inflight_joins == 1
    assert svc.metrics.cache_hits == 1
    assert svc.metrics.hit_rate > 0


def test_result_cache_lru_and_key_framing(pkg):
    ResultCache, check_key = pkg.serve.ResultCache, pkg.serve.check_key
    c = ResultCache(capacity=2)
    ka = check_key("fast_aggregate", [b"pk1"], b"m", b"s")
    kb = check_key("fast_aggregate", [b"pk2"], b"m", b"s")
    kc = check_key("fast_aggregate", [b"pk3"], b"m", b"s")
    c.put(ka, True)
    c.put(kb, False)
    assert c.get(ka) is True
    c.put(kc, True)  # evicts kb (LRU), not ka
    assert c.get(kb) is None and c.get(ka) is True and c.get(kc) is True
    assert len(c) == 2 and c.hits == 3 and c.misses == 1
    assert (check_key("fast_aggregate", [b"ab", b"c"], b"m", b"s")
            != check_key("fast_aggregate", [b"a", b"bc"], b"m", b"s"))
    assert (check_key("fast_aggregate", [b"pk"], b"m", b"s")
            != check_key("aggregate", [b"pk"], [b"m"], b"s"))
    # the same content keys the same in both packages
    assert ka == jserve.check_key("fast_aggregate", [b"pk1"], b"m", b"s")
    assert (check_key("aggregate", [b"p", b"q"], [b"m", b"n"], b"s")
            == tserve.check_key("aggregate", [b"p", b"q"], [b"m", b"n"],
                                b"s"))


def test_reference_rules_answered_eagerly(pkg):
    be = CountingBackend()
    with _svc(pkg, be) as svc:
        assert svc.submit("fast_aggregate", [], b"m", b"s").result() is False
        assert svc.submit("aggregate", [PK], [], b"s").result() is False
        assert svc.submit("aggregate", [PK], [b"a", b"b"],
                          b"s").result() is False
        pkg.bls.bls_active = False
        try:
            assert svc.submit("fast_aggregate", [PK], b"m",
                              b"s-bad").result() is True
        finally:
            pkg.bls.bls_active = True
        with pytest.raises(ValueError):
            svc.submit("proposer", [PK], b"m", b"s")
    assert be.calls == 0


# -- failure handling -------------------------------------------------------


def test_backend_failure_degrades_to_oracle(pkg):
    be = CountingBackend(fail_always=True)
    orc = CountingOracle()
    with _svc(pkg, be, oracle=orc, max_batch=4, max_wait_ms=10_000,
              backend_retries=1) as svc:
        futs = [svc.submit("fast_aggregate", [PK], b"m%d" % i,
                           b"s%d-ok" % i if i % 2 == 0 else b"s%d-bad" % i)
                for i in range(4)]
        got = [f.result(timeout=10) for f in futs]
    assert got == [True, False, True, False]
    assert be.calls == 2 and orc.calls == 4
    assert svc.metrics.fallback_items == 4
    assert svc.metrics.backend_retries == 1
    assert pkg.profiling.summary()["serve.backend_error"]["calls"] == 1


def test_port_oracle_rung_is_pure_python_and_journalled(monkeypatch):
    """The port's last rung: the default oracle is the switchboard's
    oracle_* functions, which answer on the CPU even with the switch on
    the card, so they never call the failing card path again; and the
    transition is journalled in the process flight ring with the flight
    recorder off."""
    from consensus_specs_tpu_torch.obs import flight

    monkeypatch.delenv(flight.FLIGHT_ENV, raising=False)
    monkeypatch.setattr(tbls_api, "_backend", "gpu")
    flight.reset_global()
    pool = _pool()
    items = [pool[0], pool[3]]  # k=1 valid, k=5 corrupted
    try:
        with tserve.VerificationService(
                backend=CountingBackend(fail_always=True), device="cpu",
                bucket_fn=lambda k: 8, max_batch=2, max_wait_ms=10_000,
                backend_retries=0) as svc:
            futs = [svc.submit(*it) for it in items]
            got = [f.result(timeout=120) for f in futs]
        assert got == [True, False]
        assert svc.metrics.fallback_items == 2
        notes = [e for e in flight.global_recorder().events()
                 if e["kind"] == "degraded_to_oracle"]
        assert len(notes) == 1 and notes[0]["data"]["items"] == 2
        assert "injected" in notes[0]["data"]["error"]
    finally:
        flight.reset_global()


def test_transient_failure_recovers_on_retry(pkg):
    be = CountingBackend(fail_calls=(1,))
    with _svc(pkg, be, max_batch=2, max_wait_ms=10_000,
              backend_retries=1) as svc:
        f1 = svc.submit("fast_aggregate", [PK], b"m1", b"a-ok")
        f2 = svc.submit("fast_aggregate", [PK], b"m2", b"b-ok")
        assert f1.result(timeout=10) is True and f2.result(timeout=10) is True
    assert be.calls == 2 and be.items == 2
    assert svc.metrics.fallback_items == 0


def test_backpressure_queue_full(pkg):
    be = CountingBackend(delay_s=0.5)
    svc = _svc(pkg, be, max_batch=1, max_wait_ms=0, max_queue=1)
    try:
        f1 = svc.submit("fast_aggregate", [PK], b"m1", b"a-ok")
        time.sleep(0.1)  # the stages take m1 and sleep inside the backend
        f2 = svc.submit("fast_aggregate", [PK], b"m2", b"b-ok")
        with pytest.raises(pkg.serve.QueueFull):
            svc.submit("fast_aggregate", [PK], b"m3", b"c-ok", timeout=0.05)
        assert f1.result(timeout=10) is True
        assert f2.result(timeout=10) is True
    finally:
        svc.close(timeout=30)


def test_rlc_env_off_reverts_to_per_group_path(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC", "0")
    be = OracleBackend(pkg.bls)
    kind, pks, msg, sig = _pool()[0]
    with _svc(pkg, be, max_batch=1, max_wait_ms=0) as svc:
        assert svc.submit(kind, pks, msg, sig).result(timeout=30) is True
    assert be.rlc_calls == 0 and be.calls == 1


def test_rlc_failure_degrades_to_per_group_then_oracle(pkg):
    class RlcBrokenBackend(CountingBackend):
        def batch_verify_rlc(self, items, **kw):
            self.rlc_calls += 1
            raise RuntimeError("combine program exploded")

    be = RlcBrokenBackend()
    with _svc(pkg, be, max_batch=2, max_wait_ms=10_000,
              backend_retries=1) as svc:
        f1 = svc.submit("fast_aggregate", [PK], b"m1", b"a-ok")
        f2 = svc.submit("fast_aggregate", [PK], b"m2", b"b-bad")
        assert f1.result(timeout=10) is True
        assert f2.result(timeout=10) is False
    assert be.rlc_calls == 2 and be.items == 2
    assert svc.metrics.fallback_items == 0
    assert svc.metrics.backend_retries == 1
    assert pkg.profiling.summary()["serve.rlc_error"]["calls"] == 1


def test_pipeline_prep_device_split_in_snapshot(pkg):
    be = CountingBackend()
    svc = pkg.service(be, max_batch=4, max_wait_ms=5)
    try:
        futs = [svc.submit("fast_aggregate", [PK], b"m%d" % i, b"s%d-ok" % i)
                for i in range(8)]
        assert all(f.result(timeout=10) is True for f in futs)
    finally:
        svc.close(timeout=30)
    snap = svc.metrics.snapshot()
    assert snap["prep_batches"] == snap["device_flushes"] > 0
    assert snap["batches"] >= snap["device_flushes"]
    for key in ("prep_ms_per_flush", "prep_ms_total",
                "device_ms_per_flush", "device_ms_total"):
        assert snap[key] >= 0.0
    assert "serial_fallback_items" in snap["prep"]
    assert snap["rlc"].get("combines", 0) == 0
    assert snap["final_exps_per_item"] == 0.0
    assert snap["mesh_devices"] == 0 and snap["mesh_fallbacks"] == 0


def test_deterministic_counters_equal_across_packages():
    """The deterministic streams above (size flush, transient retry,
    oracle degrade, join and cache hit) give the same counters on both
    services."""
    def stream(pkg):
        out = []
        for be_kw, n, sigs in (({}, 4, None), ({"fail_calls": (1,)}, 2, None),
                               ({"fail_always": True}, 4,
                                [b"a-ok", b"b-bad", b"c-ok", b"d-bad"])):
            be = CountingBackend(**be_kw)
            with _svc(pkg, be, max_batch=n, max_wait_ms=10_000) as svc:
                futs = [svc.submit("fast_aggregate", [PK], b"m%d" % i,
                                   sigs[i] if sigs else b"s%d-ok" % i)
                        for i in range(n)]
                verdicts = [f.result(timeout=10) for f in futs]
                # the first item again: a result-cache hit
                verdicts.append(svc.submit(
                    "fast_aggregate", [PK], b"m0",
                    sigs[0] if sigs else b"s0-ok").result(timeout=10))
            out.append((verdicts, be.calls, be.items, _counters(svc)))
        return out

    assert stream(Pkg("torch")) == stream(Pkg("jax"))


# -- randomized stream equivalence ------------------------------------------


_POOL = []


def _pool():
    """Distinct verifiable content: both kinds, mixed K buckets, a share
    of corrupt items (wrong message / wrong signature -> False); made once
    with the JAX switchboard (both switchboards sign identically)."""
    if _POOL:
        return _POOL
    bls = jbls_api
    for i, k in enumerate([1, 2, 3, 5, 1, 2, 8, 3]):
        sks = [100 * (i + 1) + j + 1 for j in range(k)]
        pks = [bls.SkToPk(sk) for sk in sks]
        msg = (b"fa%02d" % i) + b"\x00" * 28
        sig = bls.Sign(sum(sks) % R, msg)
        if i % 4 == 3:
            msg = b"\xff" + msg[1:]
        _POOL.append(("fast_aggregate", pks, msg, sig))
    for i, k in enumerate([1, 2, 3]):
        sks = [1000 + 10 * i + j + 1 for j in range(k)]
        pks = [bls.SkToPk(sk) for sk in sks]
        msgs = [(b"ag%02d_%d" % (i, j)) + b"\x00" * 24 for j in range(k)]
        sig = bls.Aggregate([bls.Sign(sk, m) for sk, m in zip(sks, msgs)])
        if i == 2:
            sig = bls.Sign(999, b"z" * 32)
        _POOL.append(("aggregate", pks, msgs, sig))
    return _POOL


def test_switchboards_sign_and_verify_alike():
    assert tbls_api.backend_name() == "py_ecc"  # the autouse fixture's
    for kind, pks, msgs, sig in _pool():
        fn = ("FastAggregateVerify" if kind == "fast_aggregate"
              else "AggregateVerify")
        assert getattr(tbls_api, fn)(pks, msgs, sig) \
            == getattr(jbls_api, fn)(pks, msgs, sig)
    assert tbls_api.SkToPk(12345) == jbls_api.SkToPk(12345)
    assert tbls_api.Sign(7, b"x" * 32) == jbls_api.Sign(7, b"x" * 32)
    assert tbls_api.Aggregate([tbls_api.Sign(7, b"x"), tbls_api.Sign(8, b"x")]) \
        == jbls_api.Aggregate([jbls_api.Sign(7, b"x"), jbls_api.Sign(8, b"x")])
    assert tbls_api.KeyValidate(b"\x00" * 48) is False


def test_use_gpu_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(tbls_api, "_backend", "py_ecc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbls_api.use_gpu()
    assert tbls_api.backend_name() == "py_ecc"


@pytest.mark.parametrize("fn", ["Verify", "AggregateVerify",
                                "FastAggregateVerify"])
def test_switchboard_default_is_the_card(monkeypatch, fn):
    """The switchboard's default backend is the card: the first verify
    call resolves it and raises where there is none, never a False
    verdict. The oracle_* functions answer on the CPU whatever the switch
    says, as the JAX switchboard's py_ecc backend does."""
    import torch

    monkeypatch.setattr(tbls_api, "_backend", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbls_api.backend_name() == "gpu"
    kind = "aggregate" if fn == "AggregateVerify" else "fast_aggregate"
    _, pks, msgs, sig = next(e for e in _pool() if e[0] == kind)
    if fn == "Verify":
        pks, msgs = pks[0], msgs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tbls_api, fn)(pks, msgs, sig)
    oracle = {"Verify": tbls_api.oracle_verify,
              "AggregateVerify": tbls_api.oracle_aggregate_verify,
              "FastAggregateVerify": tbls_api.oracle_fast_aggregate_verify}
    assert oracle[fn](pks, msgs, sig) == getattr(jbls_api, fn)(pks, msgs, sig)


def test_randomized_stream_equivalence_vs_oracle(pkg):
    """200 mixed submits (both kinds, mixed K buckets, duplicates): the
    verdicts equal the oracle's item by item, every duplicate verified
    exactly once, through the RLC route."""
    rng = random.Random(0xC0FFEE)
    pool = _pool()
    events = [pool[rng.randrange(len(pool))] for _ in range(200)]
    events[: len(pool)] = pool
    want_unique = [
        jbls_api.FastAggregateVerify(pks, m, s) if kind == "fast_aggregate"
        else jbls_api.AggregateVerify(pks, m, s)
        for kind, pks, m, s in pool]
    want = [want_unique[pool.index(e)] for e in events]

    be = OracleBackend(pkg.bls)
    svc = pkg.service(be, bucket_fn=pkg.backend._k_bucket, max_batch=32,
                      max_wait_ms=5)
    try:
        futs = [svc.submit(kind, pks, msgs, sig)
                for kind, pks, msgs, sig in events]
        got = [f.result(timeout=120) for f in futs]
    finally:
        svc.close(timeout=60)
    assert got == want
    assert any(want) and not all(want)
    assert be.items == len(pool)
    assert be.rlc_calls > 0
    m = svc.metrics
    assert m.cache_hits + m.inflight_joins == len(events) - len(pool)
    snap = m.snapshot()
    assert snap["latency"]["count"] == len(events) - m.inflight_joins
    assert 0 < snap["occupancy_rows"] <= 1


# -- the real backends -------------------------------------------------------


@pytest.fixture
def _reference_modes(monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_CHUNK", "2")
    for var in ("CONSENSUS_SPECS_TPU_HARD_PART", "CONSENSUS_SPECS_TPU_RLC_FINAL",
                "CONSENSUS_SPECS_TPU_RLC_BACKEND", "CONSENSUS_SPECS_TPU_RLC",
                "CONSENSUS_SPECS_TPU_BATCH_CODEC", "CONSENSUS_SPECS_TPU_MESH",
                "CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS"):
        monkeypatch.delenv(var, raising=False)


def test_service_with_real_backends_matches_reference(_reference_modes):
    """Both services in front of their real batched backends at
    tests/test_serve.py's shapes: both submits flush as ONE micro-batch
    through batch_verify_rlc, whose failed combined check bisects down to
    exact per-item verdicts; a duplicate is a cache hit."""
    sk1, sk2 = 41, 42
    pk1, pk2 = jbls_api.SkToPk(sk1), jbls_api.SkToPk(sk2)
    msg = b"\x05" * 32
    agg = jbls_api.Aggregate([jbls_api.Sign(sk1, msg),
                              jbls_api.Sign(sk2, msg)])
    got = {}
    for name in PKGS:
        pkg = Pkg(name)
        pkg.backend.reset_call_counts()
        rlc0 = dict(pkg.backend.RLC_STATS)
        svc = pkg.service(max_batch=2, max_wait_ms=10_000)
        try:
            f_good = svc.submit("fast_aggregate", [pk1, pk2], msg, agg)
            f_bad = svc.submit("fast_aggregate", [pk1, pk1], msg, agg)
            verdicts = [f_good.result(timeout=300), f_bad.result(timeout=300),
                        svc.submit("fast_aggregate", [pk1, pk2], msg,
                                   agg).result(timeout=60)]
        finally:
            svc.close(timeout=60)
        rlc = {k: pkg.backend.RLC_STATS[k] - rlc0[k] for k in rlc0}
        snap = svc.metrics.snapshot()
        got[name] = (verdicts, dict(pkg.backend.CALL_COUNTS), rlc,
                     snap["rlc"], snap["fallback_items"], snap["cache_hits"])
    assert got["torch"] == got["jax"]
    verdicts, calls, rlc, _, fallback, hits = got["torch"]
    assert verdicts == [True, False, True]
    assert calls == {"batch_fast_aggregate_verify": 0,
                     "batch_aggregate_verify": 0, "batch_verify_rlc": 1,
                     "items": 2}
    assert rlc["combines"] >= 1 and rlc["items"] == 2
    assert fallback == 0 and hits == 1


_BENCH_KEYS = ("sigs_served", "sigs_verified", "fallback_items", "lost",
               "wrong", "fault_injected", "events", "committees", "k")


def test_run_serve_bench_matches_reference(_reference_modes, monkeypatch):
    """Both packages' serve bench at a tiny size with the injected
    backend failure on: the same stream, served and verified alike, none
    lost or wrong."""
    from consensus_specs_tpu.serve import load as jload
    from consensus_specs_tpu_torch.serve import load as tload

    for var, value in (("SERVE_COMMITTEES", "2"), ("SERVE_K", "2"),
                       ("SERVE_EVENTS", "8"), ("SERVE_INJECT_FAILURE", "1"),
                       ("SERVE_SEED", "7")):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("SERVE_METRICS_PORT", raising=False)
    runs = {"jax": jload.run_serve_bench(),
            "torch": tload.run_serve_bench(device="cpu")}
    got = {name: {k: r[k] for k in _BENCH_KEYS} for name, r in runs.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["fault_injected"] is True
    assert got["torch"]["lost"] == got["torch"]["wrong"] == 0
    assert runs["torch"]["device"] == "cpu"
    assert "cpu" in runs["torch"]["devices"]["lanes"]
    json.dumps(runs["torch"])  # the record is JSON as it stands
