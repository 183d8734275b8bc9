"""The read-path bench of the port (the counterpart of
consensus_specs_tpu/bench/proofs.py): ``run_proofs_bench(device=None)``.

Replays 10^4-10^6 simulated light clients against the proof plane: R
distinct per-slot artifacts (R = CONSENSUS_SPECS_TPU_PROOF_SLOTS head
slots in one altair ``ProofWorld``) behind one ``ProofService``, hit by
N = CONSENSUS_SPECS_TPU_PROOF_CLIENTS client requests round-robin over
the slots from CONSENSUS_SPECS_TPU_PROOF_WORKERS request threads. The
content address ``(slot, state_root)`` makes exactly R requests builds
and every other request a cache hit or in-flight join, so the steady-
state hit rate is (N - R) / N — the >= 0.99 acceptance bar at N >= 10^4.

Every artifact is FULLY verified before the timed window: the spec's
``validate_light_client_update`` (both branches, period math, and the
sync-committee FastAggregateVerify), the combined multiproof, and the
finality branch against an independently re-Merkleized state root
(fresh ``decode_bytes`` round trip — no warm-cache reuse on the verify
side). Inside the window every request still pays the client-side
``is_valid_merkle_branch`` finality check on the artifact it received —
served bytes are never trusted unchecked.

The signature verdict routes through the port's ``VerificationService``
on ``device`` (CONSENSUS_SPECS_TPU_PROOF_BACKEND: "oracle" = the
pure-Python pairing of ``utils/bls12_381`` per update — real crypto, no
program assembly; "verdict" = the crypto-free ``VerdictBackend`` for quick
runs). The spec's own ``validate_light_client_update`` goes through the
port's switchboard, wherever its caller pointed it. The result's
``proofs`` section (per-shape ``verified`` + proofs/sec + hit rate + p99)
has the JAX bench's layout.
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor

CLIENTS_ENV = "CONSENSUS_SPECS_TPU_PROOF_CLIENTS"
SLOTS_ENV = "CONSENSUS_SPECS_TPU_PROOF_SLOTS"
WORKERS_ENV = "CONSENSUS_SPECS_TPU_PROOF_WORKERS"
BACKEND_ENV = "CONSENSUS_SPECS_TPU_PROOF_BACKEND"
# validator-registry depth of the proved states: gives artifact build a
# realistically deep Merkle tree so the build+sign phase times the
# Merkleization plane, not an empty state
VALIDATORS_ENV = "CONSENSUS_SPECS_TPU_PROOF_VALIDATORS"


class _OracleBackend:
    """Per-item pure-Python FastAggregateVerify over ``utils/bls12_381``
    (the switchboard's ``oracle_*`` functions, which never dispatch to the
    card): real pairings with no program assembly; only the R distinct
    artifact builds ever reach it. ``device`` is accepted, as the service
    passes it, and ignored."""

    def __init__(self):
        self.calls = 0
        self.items = 0

    def batch_fast_aggregate_verify(self, pubkey_sets, messages, signatures,
                                    device=None):
        from ..utils import bls

        self.calls += 1
        self.items += len(signatures)
        return [
            bool(bls.oracle_fast_aggregate_verify(
                list(pks), bytes(msg), bytes(sig)))
            for pks, msg, sig in zip(pubkey_sets, messages, signatures)
        ]

    def batch_aggregate_verify(self, pubkey_sets, message_sets, signatures,
                               device=None):
        from ..utils import bls

        self.calls += 1
        self.items += len(signatures)
        return [
            bool(bls.oracle_aggregate_verify(
                list(pks), [bytes(m) for m in msgs], bytes(sig)))
            for pks, msgs, sig in zip(pubkey_sets, message_sets, signatures)
        ]


def run_proofs_bench(device=None) -> dict:
    """Run the proof-serving replay with its ``VerificationService`` on
    ``device`` (None: the CUDA card); returns the JAX bench's result
    dict."""
    from ..builder import build_spec_module
    from ..device import resolve_device
    from ..lightclient.proof_tree import (
        ProofWorld, build_update_artifact, floorlog2, subtree_index,
        verify_artifact,
    )
    from ..lightclient.serve_proofs import ProofService
    from ..obs import latency
    from ..ops import profiling
    from ..serve.service import VerificationService

    profiling.reset()
    latency.reset()

    n_clients = int(os.environ.get(CLIENTS_ENV, "20000"))
    n_slots = max(1, int(os.environ.get(SLOTS_ENV, "8")))
    n_workers = max(1, int(os.environ.get(WORKERS_ENV, "4")))
    backend_kind = os.environ.get(BACKEND_ENV, "oracle").strip() or "oracle"
    n_validators = int(os.environ.get(VALIDATORS_ENV, "16384"))

    spec = build_spec_module("altair", "minimal")
    world = ProofWorld(spec, validators=n_validators)
    if backend_kind == "verdict":
        from ..serve.load import VerdictBackend

        backend = VerdictBackend()
    else:
        backend = _OracleBackend()
    device = resolve_device(device)
    verifier = VerificationService(backend, device=device, max_batch=8,
                                   max_wait_ms=1.0)
    service = ProofService(verifier=verifier)

    head_slots = [world.finalized_slot + 1 + i for i in range(n_slots)]
    states = {s: world.head_state(s) for s in head_slots}
    roots = {s: bytes(states[s].hash_tree_root()) for s in head_slots}

    def build(slot):
        return build_update_artifact(
            spec, states[slot], world.finalized_state,
            genesis_validators_root=world.genesis_validators_root,
            sign=world.sign)

    all_verified = True
    try:
        # -- the artifact build+sign phase (the Merkleization plane's
        # consumer-facing number): per-slot build_update_artifact timing
        # on COLD states (fresh decode, no warm caches), native vs the
        # forced pure-python oracle in the same round -----------------------
        from ..merkle import levels as _merkle_levels

        enc_fin = world.finalized_state.encode_bytes()

        def timed_build_sign(mode: str, slot: int) -> float:
            st = spec.BeaconState.decode_bytes(states[slot].encode_bytes())
            fin = spec.BeaconState.decode_bytes(enc_fin)
            with _merkle_levels.forced_mode(mode):
                t0 = time.perf_counter()
                build_update_artifact(
                    spec, st, fin,
                    genesis_validators_root=world.genesis_validators_root,
                    sign=world.sign)
                return time.perf_counter() - t0

        bs_native = min(timed_build_sign("native", s) for s in head_slots)
        bs_python = min(timed_build_sign("python", s) for s in head_slots)

        # -- warm + full verification of every distinct artifact ----------
        t_build = time.perf_counter()
        for s in head_slots:
            artifact = service.serve(s, roots[s], lambda s=s: build(s))
            # service-side verdict (VerificationService BLS fast path)
            all_verified &= artifact.verified is True
            # client-side: the whole spec check against an independently
            # re-Merkleized root (fresh deserialization, cold caches)
            fresh = spec.BeaconState.decode_bytes(states[s].encode_bytes())
            verify_artifact(
                spec, artifact, world.snapshot,
                world.genesis_validators_root,
                state_root=bytes(fresh.hash_tree_root()))
        build_s = time.perf_counter() - t_build

        # -- the timed client replay --------------------------------------
        def one_request(i: int) -> bool:
            slot = head_slots[i % n_slots]
            artifact = service.serve(slot, roots[slot],
                                     lambda: build(slot))
            # every served proof is checked, not trusted: the finality
            # branch must re-hash to the requested state root
            g = artifact.finality_gindex
            ok = artifact.verified is True and spec.is_valid_merkle_branch(
                spec.Root(artifact.finalized_root),
                [spec.Bytes32(b) for b in artifact.finality_branch],
                floorlog2(g), subtree_index(g),
                spec.Root(bytes(roots[slot])))
            return bool(ok)

        t0 = time.perf_counter()
        if n_workers == 1:
            checked = sum(one_request(i) for i in range(n_clients))
        else:
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                checked = sum(pool.map(one_request, range(n_clients),
                                       chunksize=256))
        elapsed = time.perf_counter() - t0
        all_verified &= checked == n_clients
    finally:
        verifier.close(timeout=30)

    pps = n_clients / elapsed if elapsed > 0 else 0.0
    hit_rate = service.metrics.hit_rate
    service.export_gauges()
    lat = latency.snapshot()
    serve_summary = lat.get(latency.stage_label("proof_serve"), {})
    p99_ms = float(serve_summary.get("p99_ms", 0.0))

    shape = f"clients={n_clients}"
    proofs_section = {
        shape: {
            "verified": bool(all_verified),
            "proofs_per_sec": round(pps, 2),
            "hit_rate": round(hit_rate, 6),
            "p99_ms": round(p99_ms, 4),
            "clients": n_clients,
            "slots": n_slots,
            "workers": n_workers,
            "backend": backend_kind,
            "validators": n_validators,
            # per-slot artifact build+sign on cold states: the native
            # Merkleization plane vs the forced pure-python oracle
            "build_sign_s_per_slot": round(bs_native, 4),
            "build_sign_s_per_slot_python": round(bs_python, 4),
        }
    }
    return dict(
        metric="light-client proofs served/sec",
        value=round(pps, 2),
        # the acceptance bar: content-addressed steady-state hit rate
        vs_baseline=round(hit_rate, 4),
        unit="proofs/sec",
        mode="proofs",
        platform=device.type,
        clients=n_clients,
        slots=n_slots,
        workers=n_workers,
        backend=backend_kind,
        distinct_artifacts=n_slots,
        verified=bool(all_verified),
        checked_requests=int(checked),
        hit_rate=round(hit_rate, 6),
        p99_ms=round(p99_ms, 4),
        build_s=round(build_s, 3),
        build_sign_s_per_slot=round(bs_native, 4),
        build_sign_s_per_slot_python=round(bs_python, 4),
        validators=n_validators,
        elapsed_s=round(elapsed, 3),
        proofs=proofs_section,
        per_mode_best={f"proofs[{shape}]": round(pps, 2)},
        stage_latency=lat,
        service=service.snapshot(),
        profile=profiling.summary(),
    )
