"""The port's light-client proof plane (consensus_specs_tpu_torch/
lightclient/ and utils/ssz/proofs.py, with bench/proofs.py) against the
JAX package's, on the CPU.

The same world is built on both packages (altair minimal, the same 32
secret keys drawn with a numpy seed, a registry of 64 validators), each
on its own spec, SSZ and switchboard (the port's on its CPU oracle). Then
the packages are held to each other, exact bytes everywhere (no
tolerance): the multiproof helpers over random index sets, cold caches
against warm; every artifact field by serialized bytes and roots; the
client-side verification and its tamper controls; the ``ProofService``
cache, in-flight dedup, failure and verdict semantics of
tests/test_lightclient.py, on both packages; the proofs bench on the
``verdict`` backend; and the ``lightclient`` metric families rendered
by both registries.
"""
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from tests.torch_threads import one_thread

one_thread()

PKGS = ("jax", "torch")
_ROOTS = {"jax": "consensus_specs_tpu", "torch": "consensus_specs_tpu_torch"}
VALIDATORS = 64
_SURFACES = {}


def _sks():
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    rng = np.random.default_rng(16)
    return [int.from_bytes(rng.bytes(32), "little") % (R - 1) + 1
            for _ in range(32)]


def _surface(name):
    """One package's proof surface: its spec (altair minimal), its world,
    and its lightclient, proofs, serve and obs modules."""
    import importlib

    if name in _SURFACES:
        return _SURFACES[name]
    root = _ROOTS[name]
    mod = lambda path: importlib.import_module(f"{root}.{path}")  # noqa
    p = types.SimpleNamespace(name=name)
    p.spec = mod("builder").build_spec_module("altair", "minimal")
    p.proof_tree = mod("lightclient.proof_tree")
    p.serve_proofs = mod("lightclient.serve_proofs")
    p.proofs = mod("utils.ssz.proofs")
    p.gindex = mod("utils.ssz.gindex")
    p.load = mod("serve.load")
    p.profiling = mod("ops.profiling")
    p.registry = mod("obs.registry")
    p.bench = mod("bench.proofs")
    p.node = mod("sim.node")
    service_cls = mod("serve.service").VerificationService
    kw = {} if name == "jax" else {"device": "cpu"}
    p.service = lambda backend, **k: service_cls(backend, **kw, **k)
    p.bench_kw = kw
    p.world = p.proof_tree.ProofWorld(p.spec, sks=_sks(),
                                      validators=VALIDATORS)
    _SURFACES[name] = p
    return p


@pytest.fixture(autouse=True)
def _switchboards():
    """The port's spec checks run on its CPU oracle here; its backend and
    both profiling surfaces come back after."""
    from consensus_specs_tpu.ops import profiling as jprofiling
    from consensus_specs_tpu_torch.ops import profiling as tprofiling
    from consensus_specs_tpu_torch.utils import bls as tbls

    was = tbls._backend
    tbls.use_py_ecc()
    yield
    tbls._backend = was
    jprofiling.reset()
    tprofiling.reset()


@pytest.fixture(params=PKGS)
def p(request):
    return _surface(request.param)


@pytest.fixture
def both():
    return _surface("jax"), _surface("torch")


def _hex(xs):
    return [bytes(x).hex() for x in xs]


# -- the multiproof helpers ---------------------------------------------------


def _gindex_pool(p, state):
    """Valid generalized indices of a head state: every field, the
    finalized checkpoint's root, and validators, their fields and
    balances (chunks) at a few registry positions."""
    get = p.gindex.get_generalized_index
    typ = type(state)
    out = [int(get(typ, name)) for name in typ.fields()]
    out.append(int(get(typ, "finalized_checkpoint", "root")))
    for i in (0, 1, 7, 31, 63):
        out.append(int(get(typ, "validators", i)))
        out.append(int(get(typ, "validators", i, "pubkey")))
        out.append(int(get(typ, "validators", i, "effective_balance")))
        out.append(int(get(typ, "balances", i)))
    return sorted(set(out))


def test_multiproof_helpers_equal_on_random_index_sets(both):
    """Over random index sets (numpy seed): the helper, branch and path
    index algebra, and the multiproof's leaves and proof from a cold state
    (fresh decode) and a warm one, equal bytes on both packages; each
    proof re-hashes to the state root by both packages' verifiers."""
    rng = np.random.default_rng(7)
    states = {}
    for q in both:
        states[q.name] = q.world.head_state(q.world.finalized_slot + 1)
    pool = _gindex_pool(both[1], states["torch"])
    assert pool == _gindex_pool(both[0], states["jax"])
    root = bytes(states["jax"].hash_tree_root())
    assert bytes(states["torch"].hash_tree_root()) == root
    for _ in range(12):
        n = int(rng.integers(1, 6))
        picks = sorted(int(g) for g in rng.choice(pool, size=n, replace=False))
        # a multiproof's indices must not be ancestors of one another
        picks = [g for g in picks
                 if not any(h.bit_length() < g.bit_length()
                            and g >> (g.bit_length() - h.bit_length()) == h
                            for h in picks)]
        got = {}
        for q in both:
            helpers = [int(h) for h in q.proofs.get_helper_indices(picks)]
            branches = [[int(h) for h in q.proofs.get_branch_indices(g)]
                        for g in picks]
            paths = [[int(h) for h in q.proofs.get_path_indices(g)]
                     for g in picks]
            warm = states[q.name]
            cold = q.spec.BeaconState.decode_bytes(warm.encode_bytes())
            proofs = []
            for view in (cold, warm):  # cold first: no cache yet
                leaves, proof = q.proofs.build_multiproof(view, picks)
                assert q.proofs.verify_merkle_multiproof(
                    leaves, proof, picks, root)
                proofs.append((_hex(leaves), _hex(proof)))
            assert proofs[0] == proofs[1]
            got[q.name] = (helpers, branches, paths, proofs[0])
        assert got["torch"] == got["jax"], picks
        # either package's verifier accepts the other's proof
        leaves = [bytes.fromhex(x) for x in got["torch"][3][0]]
        proof = [bytes.fromhex(x) for x in got["torch"][3][1]]
        assert both[0].proofs.calculate_multi_merkle_root(
            leaves, proof, picks) == root


def test_single_proofs_and_bundles_equal(both):
    paths = [("finalized_checkpoint", "root"), ("next_sync_committee",),
             ("validators", 5, "pubkey"), ("balances", 9)]
    got = {}
    for q in both:
        state = q.world.head_state(q.world.finalized_slot + 2)
        singles = [_hex(q.proofs.build_proof(state, *path)) for path in paths]
        gs = [int(q.gindex.get_generalized_index(type(state), *path))
              for path in paths[:2]]
        branches, leaves, proof = q.proofs.build_proof_bundle(
            state, paths=paths, gindices=gs)
        assert [_hex(branches[tuple(path)]) for path in paths] == singles
        for path, branch in zip(paths, singles):
            g = q.gindex.get_generalized_index(type(state), *path)
            leaf = q.proofs.get_tree_node(state, g)
            assert q.proofs.verify_merkle_proof(
                leaf, [bytes.fromhex(b) for b in branch], g,
                state.hash_tree_root())
        got[q.name] = (singles, _hex(leaves), _hex(proof))
    assert got["torch"] == got["jax"]


# -- the artifacts ------------------------------------------------------------


def _artifact_bytes(a):
    return {
        "slot": a.slot, "state_root": a.state_root.hex(),
        "finalized_root": a.finalized_root.hex(),
        "finality_branch": _hex(a.finality_branch),
        "finality_gindex": a.finality_gindex,
        "sync_committee_root": a.sync_committee_root.hex(),
        "sync_branch": _hex(a.sync_branch), "sync_gindex": a.sync_gindex,
        "multi_gindices": list(a.multi_gindices),
        "multi_leaves": _hex(a.multi_leaves),
        "multi_proof": _hex(a.multi_proof),
        "signing_root": a.signing_root.hex(),
        "participants": _hex(a.participant_pubkeys),
        "update": (None if a.update is None
                   else a.update.encode_bytes().hex()),
        "update_root": (None if a.update is None
                        else bytes(a.update.hash_tree_root()).hex()),
    }


def test_world_and_artifacts_equal_by_bytes_and_roots(both):
    jw, tw = both[0].world, both[1].world
    assert tw.pubkeys == jw.pubkeys
    assert tw.finalized_state_root == jw.finalized_state_root
    assert tw.finalized_header_root == jw.finalized_header_root
    assert (tw.finalized_state.encode_bytes()
            == jw.finalized_state.encode_bytes())
    assert (tw.snapshot.encode_bytes() == jw.snapshot.encode_bytes())
    for offset, signed in ((1, True), (3, False)):
        slot = jw.finalized_slot + offset
        arts = [q.world.build_artifact(slot, signed=signed) for q in both]
        assert _artifact_bytes(arts[1]) == _artifact_bytes(arts[0])
        assert arts[1].key == arts[0].key
        assert (both[1].proof_tree.proof_key(slot, arts[1].state_root)
                == both[0].proof_tree.proof_key(slot, arts[0].state_root))
        states = [q.world.head_state(slot) for q in both]
        assert states[1].encode_bytes() == states[0].encode_bytes()


def test_head_state_writes_reach_no_other_state_alike(both):
    """A write to one head state's registry reaches neither the finalized
    state, nor its root, nor a later head state: each state owns its
    registry on both packages (sks 1..32, 8 validators)."""
    worlds = [q.proof_tree.ProofWorld(q.spec, sks=range(1, 33),
                                      validators=8) for q in both]
    heads = []
    for w in worlds:
        h = w.head_state(w.finalized_slot + 3)
        h.validators[0].effective_balance = 1
        h.balances[1] = 5
        heads.append(h)
    for w in worlds:
        fin = w.finalized_state
        assert int(fin.validators[0].effective_balance) == 32 * 10**9
        assert int(fin.balances[1]) == 32 * 10**9
        assert bytes(fin.hash_tree_root()) == w.finalized_state_root
    jw, tw = worlds
    assert (tw.finalized_state.encode_bytes()
            == jw.finalized_state.encode_bytes())
    assert tw.finalized_state_root == jw.finalized_state_root
    fresh = [w.head_state(w.finalized_slot + 3) for w in worlds]
    assert int(fresh[1].validators[0].effective_balance) == 32 * 10**9
    assert fresh[1].encode_bytes() == fresh[0].encode_bytes()
    assert bytes(fresh[1].hash_tree_root()) == bytes(fresh[0].hash_tree_root())
    assert heads[1].encode_bytes() == heads[0].encode_bytes()
    assert bytes(heads[1].hash_tree_root()) == bytes(heads[0].hash_tree_root())
    assert bytes(heads[1].hash_tree_root()) != bytes(
        fresh[1].hash_tree_root())


def test_verify_artifact_passes_and_tampering_fails_on_both(p):
    spec, world = p.spec, p.world
    slot = world.finalized_slot + 4
    state = world.head_state(slot)
    fresh = spec.BeaconState.decode_bytes(state.encode_bytes())
    artifact = world.build_artifact(slot)
    assert len(artifact.participant_pubkeys) == int(spec.SYNC_COMMITTEE_SIZE)
    p.proof_tree.verify_artifact(
        spec, artifact, world.snapshot, world.genesis_validators_root,
        state_root=bytes(fresh.hash_tree_root()))
    # a flipped finality-branch byte: the spec validate rejects it
    bad = world.build_artifact(slot)
    bad.finality_branch[0] = bytes(
        [bad.finality_branch[0][0] ^ 1]) + bad.finality_branch[0][1:]
    bad.update.finality_branch = [spec.Bytes32(b)
                                  for b in bad.finality_branch]
    with pytest.raises(AssertionError):
        p.proof_tree.verify_artifact(spec, bad, world.snapshot,
                                     world.genesis_validators_root)
    # a corrupted signature: branches fine, FastAggregateVerify False
    bad = world.build_artifact(slot)
    sig = bytes(bad.update.sync_committee_signature)
    bad.update.sync_committee_signature = spec.BLSSignature(
        sig[:-1] + bytes([sig[-1] ^ 1]))
    with pytest.raises(AssertionError):
        p.proof_tree.verify_artifact(spec, bad, world.snapshot,
                                     world.genesis_validators_root)
    # signed under a wrong key: the same bytes otherwise, rejected
    bad = p.proof_tree.build_update_artifact(
        spec, state, world.finalized_state,
        genesis_validators_root=world.genesis_validators_root,
        sign=lambda root: ([True] * len(world.sks), world._bls.Sign(
            (sum(world.sks) + 1) % world._bls.R, bytes(root))))
    with pytest.raises(AssertionError):
        p.proof_tree.verify_artifact(spec, bad, world.snapshot,
                                     world.genesis_validators_root)
    # the multiproof against another root
    with pytest.raises(AssertionError):
        p.proof_tree.verify_artifact(
            spec, artifact, world.snapshot, world.genesis_validators_root,
            state_root=b"\x99" * 32)


def test_head_proof_round_trip_and_tamper_equal(both):
    got = {}
    for q in both:
        state = q.world.head_state(q.world.finalized_slot + 6)
        root = bytes(state.hash_tree_root())
        artifact = q.proof_tree.build_head_proof(q.spec, state)
        assert artifact.update is None
        q.proof_tree.verify_head_proof(q.spec, artifact, root)
        with pytest.raises(AssertionError):
            q.proof_tree.verify_head_proof(q.spec, artifact, b"\x99" * 32)
        got[q.name] = _artifact_bytes(artifact)
        artifact.finalized_root = b"\x99" * 32
        with pytest.raises(AssertionError):
            q.proof_tree.verify_head_proof(q.spec, artifact, root)
    assert got["torch"] == got["jax"]


# -- the serving front (tests/test_lightclient.py:64-216, both packages) -----


def _plain_artifact(p, slot=7, root=b"\x07" * 32):
    return p.proof_tree.ProofArtifact(slot=slot, state_root=root,
                                      finalized_root=b"", finality_branch=[])


def test_proof_key_content_addressing(p):
    r1, r2 = b"\x01" * 32, b"\x02" * 32
    key = p.proof_tree.proof_key
    assert key(5, r1) == key(5, r1)
    assert key(5, r1) != key(6, r1)
    assert key(5, r1) != key(5, r2)
    assert key(1, b"\x00" * 4) != key(1, b"\x00" * 8)
    assert _plain_artifact(p, 9, r1).key == key(9, r1)


def test_proof_cache_lru_bounds_and_counters(p):
    cache = p.serve_proofs.ProofCache(capacity=2)
    arts = {i: _plain_artifact(p, i, bytes([i]) * 32) for i in range(3)}
    keys = {i: arts[i].key for i in range(3)}
    assert cache.get(keys[0]) is None
    cache.put(keys[0], arts[0])
    cache.put(keys[1], arts[1])
    assert cache.get(keys[0]) is arts[0]
    cache.put(keys[2], arts[2])  # evicts 1, not 0
    assert cache.get(keys[1]) is None
    assert cache.get(keys[0]) is arts[0]
    assert len(cache) == 2
    assert cache.hits == 2 and cache.misses == 2
    assert cache.hit_rate == 0.5


def test_proof_metrics_hit_rate_counts_joins_and_exports_gauges(p):
    p.profiling.reset()
    m = p.serve_proofs.ProofMetrics(node=None)
    m.note_build()
    m.note_served()
    m.note_served(hit=True)
    m.note_served(joined=True)
    m.note_verdict(True)
    m.note_verdict(False)
    assert m.served == 3 and m.builds == 1
    assert m.hit_rate == pytest.approx(2 / 3)
    m.export_gauges()
    summary = p.profiling.summary()
    assert summary["lightclient.proofs_served"]["gauge"] == 3
    assert summary["lightclient.proof_builds"]["gauge"] == 1
    assert summary["lightclient.inflight_joins"]["gauge"] == 1
    assert summary["lightclient.updates_verified"]["gauge"] == 1
    assert summary["lightclient.verify_failures"]["gauge"] == 1
    assert summary["lightclient.cache_hit_rate"]["gauge"] == \
        pytest.approx(2 / 3)


def test_proof_service_builds_once_then_hits(p):
    svc = p.serve_proofs.ProofService(capacity=8)
    builds = []

    def build():
        builds.append(1)
        return _plain_artifact(p)

    a1 = svc.serve(7, b"\x07" * 32, build)
    a2 = svc.serve(7, b"\x07" * 32, build)
    assert a1 is a2 and len(builds) == 1
    snap = svc.snapshot()
    assert snap["served"] == 2 and snap["builds"] == 1
    assert snap["cache_hits"] == 1 and snap["hit_rate"] == 0.5
    assert snap["cache_entries"] == 1 and snap["pending"] == 0


def test_proof_service_inflight_dedup_joins_one_build(p):
    svc = p.serve_proofs.ProofService(capacity=8)
    builds = []
    release = threading.Event()

    def slow_build():
        builds.append(1)
        release.wait(timeout=30)
        return _plain_artifact(p)

    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = [pool.submit(svc.serve, 7, b"\x07" * 32, slow_build)
                for _ in range(4)]
        deadline = time.time() + 30
        while time.time() < deadline:
            if builds and svc.snapshot()["pending"] == 1:
                break
            time.sleep(0.01)
        release.set()
        got = [f.result(timeout=30) for f in futs]
    assert len(builds) == 1
    assert all(g is got[0] for g in got)
    snap = svc.snapshot()
    assert snap["served"] == 4 and snap["builds"] == 1
    assert snap["inflight_joins"] == 3 and snap["pending"] == 0


def test_proof_service_failed_build_propagates_and_clears(p):
    svc = p.serve_proofs.ProofService(capacity=8)

    def bad_build():
        raise RuntimeError("no such state")

    with pytest.raises(RuntimeError):
        svc.serve(7, b"\x07" * 32, bad_build)
    assert svc.snapshot()["pending"] == 0
    art = svc.serve(7, b"\x07" * 32, lambda: _plain_artifact(p))
    assert art.slot == 7


def _verdict_artifact(p, signature):
    art = _plain_artifact(p)
    art.update = types.SimpleNamespace(sync_committee_signature=signature)
    art.signing_root = b"\x0a" * 32
    art.participant_pubkeys = [b"\xc0" + b"\x00" * 47]
    return art


def test_proof_service_verdicts_through_each_verification_service(both):
    got = {}
    for q in both:
        backend = q.load.VerdictBackend()
        verifier = q.service(backend, max_batch=8, max_wait_ms=1.0)
        try:
            svc = q.serve_proofs.ProofService(verifier=verifier)
            good = svc.serve(1, b"\x01" * 32,
                             lambda: _verdict_artifact(q, b"\x05" * 96))
            bad = svc.serve(2, b"\x02" * 32, lambda: _verdict_artifact(
                q, q.load.BAD_SIGNATURE))
            snap = svc.snapshot()
            assert backend.calls >= 1
        finally:
            verifier.close(timeout=30)
        got[q.name] = (good.verified, bad.verified,
                       snap["updates_verified"], snap["verify_failures"])
        unverified = q.serve_proofs.ProofService().serve(
            3, b"\x03" * 32, lambda: _verdict_artifact(q, b"\x05" * 96))
        assert unverified.verified is None
    assert got["torch"] == got["jax"] == (True, False, 1, 1)


def test_real_world_verdict_through_each_verification_service(both):
    """The world's signed artifact and one signed under a wrong key
    through each package's service over the pure-Python oracle backend:
    the same verdicts."""
    got = {}
    for q in both:
        verifier = q.service(q.bench._OracleBackend(), max_batch=8,
                             max_wait_ms=1.0)
        try:
            svc = q.serve_proofs.ProofService(verifier=verifier)
            w = q.world
            slot = w.finalized_slot + 7
            state = w.head_state(slot)
            good = svc.serve(slot, bytes(state.hash_tree_root()),
                             lambda: w.build_artifact(slot))

            def wrong_key(root):
                return [True] * len(w.sks), w._bls.Sign(
                    (sum(w.sks) + 1) % w._bls.R, bytes(root))

            bad = svc.serve(slot, b"\x01" * 32, lambda: (
                q.proof_tree.build_update_artifact(
                    q.spec, state, w.finalized_state,
                    genesis_validators_root=w.genesis_validators_root,
                    sign=wrong_key)))
        finally:
            verifier.close(timeout=30)
        got[q.name] = (good.verified, bad.verified, svc.snapshot()["builds"])
    assert got["torch"] == got["jax"] == (True, False, 2)


# -- the proofs bench ---------------------------------------------------------


def test_proofs_bench_verdict_backend_equal(both, monkeypatch):
    """A tiny verdict-backend replay on both packages: the same
    ``verified``, checked requests, builds and (N - R)/N hit rate; the
    warm phase runs the full spec verification on both."""
    for key, value in (("CLIENTS", "64"), ("SLOTS", "2"), ("WORKERS", "2"),
                       ("BACKEND", "verdict"), ("VALIDATORS", "64")):
        monkeypatch.setenv(f"CONSENSUS_SPECS_TPU_PROOF_{key}", value)
    got = {}
    for q in both:
        result = q.bench.run_proofs_bench(**q.bench_kw)
        row = result["proofs"]["clients=64"]
        assert row["proofs_per_sec"] > 0 and row["p99_ms"] >= 0
        assert result["per_mode_best"] == {
            "proofs[clients=64]": row["proofs_per_sec"]}
        got[q.name] = (result["mode"], result["platform"], result["verified"],
                       result["checked_requests"], row["verified"],
                       row["hit_rate"], result["service"]["builds"],
                       sorted(result["proofs"]))
    assert got["torch"] == got["jax"]
    assert got["torch"][2] is True
    assert got["torch"][5] == pytest.approx((66 - 2) / 66)


# -- the metric families ------------------------------------------------------


def test_registries_render_proof_metrics_alike(both):
    """A ``ProofMetrics`` snapshot, plain and node-labelled, rendered by
    both registries: the same metric families, with the JAX package's
    help text."""
    fams = {}
    for q in both:
        q.profiling.reset()
        for node in (None, "n1"):
            m = q.serve_proofs.ProofMetrics(node=node)
            m.note_build()
            m.note_served()
            m.note_served(hit=True)
            m.note_verdict(True)
            m.export_gauges()
        text = q.registry.render_prometheus()
        fams[q.name] = sorted(
            line for line in text.splitlines()
            if line.startswith("#") and "lightclient" in line)
        q.profiling.reset()
    assert fams["torch"] == fams["jax"]
    assert any("lightclient_node" in line for line in fams["torch"])
    assert sum("TYPE" in line for line in fams["torch"]) == 7
    jreg, treg = both[0].registry, both[1].registry
    for name, text in jreg.GAUGES.items():
        if name.startswith("lightclient."):
            assert treg.GAUGES[name] == text
    assert treg.DYNAMIC_PREFIXES["lightclient["] == \
        jreg.DYNAMIC_PREFIXES["lightclient["]


# -- the simnet light-client node kind ----------------------------------------


class _StubServer:
    def __init__(self, name, response):
        self.name = name
        self.response = response

    def serve_head_proof(self):
        return dict(self.response)


def _head_response(q, slot):
    state = q.world.head_state(slot)
    block = q.spec.BeaconBlock(slot=q.spec.Slot(slot))
    return {"state": state, "node": "n0",
            "head_root": bytes(q.spec.hash_tree_root(block)),
            "head_slot": slot, "block": block,
            "artifact": q.proof_tree.build_head_proof(q.spec, state)}


def test_light_client_node_accepts_rejects_and_staleness_alike(both):
    got = {}
    for q in both:
        slot = q.world.finalized_slot + 8
        fresh = _head_response(q, slot)
        client = q.node.LightClientNode(0, q.spec, fresh["state"])
        outcomes = [client.fetch(_StubServer("n0", fresh))]
        lying = dict(_head_response(q, slot + 1))
        lying["artifact"] = q.proof_tree.build_head_proof(
            q.spec, q.world.head_state(slot + 1))
        outcomes.append(client.fetch(_StubServer("n1", lying)))
        forged = dict(fresh, head_root=b"\x55" * 32)
        outcomes.append(client.fetch(_StubServer("n2", forged)))
        stale = dict(fresh, head_slot=slot - 1,
                     block=q.spec.BeaconBlock(slot=q.spec.Slot(slot - 1)))
        stale["head_root"] = bytes(q.spec.hash_tree_root(stale["block"]))
        outcomes.append(client.fetch(_StubServer("n3", stale)))
        kinds = [e["kind"] for e in client.recorder.events()]
        got[q.name] = (outcomes, client.snapshot(), kinds)
    assert got["torch"] == got["jax"]
    outcomes, snap, kinds = got["torch"]
    assert outcomes == [True, False, False, False]
    assert snap["verified"] == 1 and snap["failures"] == 2
    assert snap["rejected_stale"] == 1
    assert kinds.count("proof_reject") == 2


# -- the proof smoke ----------------------------------------------------------


def test_proof_smoke_round_trip_on_a_cpu_fleet(tmp_path, monkeypatch):
    """The port's proof smoke on 2 ``bls`` workers on the CPU: the fleet's
    verdict on the served update, a cache hit, every worker's own verdict,
    the client-side checks on the switchboard's oracle, and the journal."""
    from consensus_specs_tpu_torch.lightclient import proof_smoke
    from consensus_specs_tpu_torch.obs import flight

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                       str(tmp_path / proof_smoke.JOURNAL_PATH))
    flight.reset_global()
    report = {}
    try:
        assert proof_smoke.main(device="cpu", report=report) == 0
    finally:
        flight.reset_global()
    result = report["result"]
    assert result["device"] == "cpu" and result["seats"] == 32
    assert result["builds"] == 1 and result["cache_hits"] == 1
    assert sorted(report["snapshots"]) == ["w0", "w1"]
    assert (tmp_path / proof_smoke.JOURNAL_PATH).read_text().count(
        "proof_build") >= 1
