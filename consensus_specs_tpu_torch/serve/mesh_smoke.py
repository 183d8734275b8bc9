"""Mesh-plane convergence canary (the port's copy of
consensus_specs_tpu/serve/mesh_smoke.py).

One serve-plane flush on a 4-slot mesh (of the card by default; of the CPU
with ``--device cpu``), held to the strict verdict-identity gate: every
verdict the mesh-sharded service returns must equal (a) the single-device
RLC path's and (b) the pure-Python host oracle's, over a batch that holds
every input class: valid committees, a corrupted message (which forces a
bisection through the failed SHARDED combine), a malformed signature and
an infinity pubkey. The flight recorder is armed for the run; on failure
the journal dumps to ``mesh_flight.jsonl`` so the divergence post-mortem
exists without a rerun, and on success the journal must show no
degradation-ladder transition: a mesh smoke that passes only because it
fell back to the single-device path fails. (The combine's butterfly
raises on failure, which the service's rung 0 turns into a mesh
fallback.)

    python -m consensus_specs_tpu_torch.serve.mesh_smoke [--device cpu]

Exit 0 on pass; 1 with a diagnosis line otherwise. ``main`` sets
CONSENSUS_SPECS_TPU_MESH, _FLIGHT and _FLIGHT_DUMP for its run and
restores them after.
"""
import os
import sys

MESH_DEVICES = 4
_ENV = ("CONSENSUS_SPECS_TPU_MESH", "CONSENSUS_SPECS_TPU_FLIGHT",
        "CONSENSUS_SPECS_TPU_FLIGHT_DUMP")


def main(device=None) -> int:
    was = {k: os.environ.get(k) for k in _ENV}
    os.environ["CONSENSUS_SPECS_TPU_MESH"] = str(MESH_DEVICES)
    os.environ["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"
    os.environ.setdefault("CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                          "mesh_flight.jsonl")
    try:
        return _run(device)
    finally:
        for k, v in was.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(device) -> int:
    from ..device import resolve_device
    from ..obs import flight
    from ..ops import bls_backend, profiling
    from ..utils import bls
    from ..utils.bls12_381 import R
    from .service import VerificationService

    dev = resolve_device(device)

    def committee(tag, k=1, good=True):
        sks = [9000 * tag + j + 1 for j in range(k)]
        pks = [bls.SkToPk(sk) for sk in sks]
        msg = (b"smk%03d" % tag) + b"\x00" * 26
        sig = bls.Sign(sum(sks) % R, msg)
        if not good:
            msg = b"\xff" + msg[1:]
        return ("fast_aggregate", pks, msg, sig)

    items = [
        committee(1, k=2),
        committee(2),
        committee(3, good=False),                      # corrupted: bisection
        ("fast_aggregate", [bls.SkToPk(7)], b"m" * 32,
         b"\xa0" + b"\x01" * 95),                      # undecodable signature
        ("fast_aggregate", [b"\xc0" + b"\x00" * 47],
         b"p" * 32, bls.Sign(9, b"p" * 32)),           # infinity pubkey
    ]
    want = [True, True, False, False, False]

    flight.reset_global()
    rec = flight.global_recorder()
    try:
        # host-oracle truth (the reference's exception-swallowing rules)
        def oracle_one(kind, pks, msg, sig):
            try:
                return bool(bls.oracle_fast_aggregate_verify(pks, msg, sig))
            except Exception:
                return False

        oracle = [oracle_one(*it) for it in items]
        assert oracle == want, f"oracle drifted from the pinned pattern: " \
            f"{oracle} != {want}"

        # max_wait sized so all five submits join ONE flush: a flush
        # narrower than the mesh would route to the single-device path
        # and the smoke would no longer exercise the sharded combine
        profiling.reset()
        svc = VerificationService(device=dev, max_wait_ms=300.0)
        assert svc.mesh_devices == MESH_DEVICES, (
            f"mesh not armed: service spans {svc.mesh_devices} slots "
            f"(CONSENSUS_SPECS_TPU_MESH={os.environ['CONSENSUS_SPECS_TPU_MESH']})"
        )
        stats_before = dict(bls_backend.RLC_STATS)
        try:
            futures = [svc.submit(*it) for it in items]
            got = [bool(f.result(timeout=600)) for f in futures]
        finally:
            svc.close(timeout=60)
        svc_bisections = (bls_backend.RLC_STATS["bisections"]
                          - stats_before["bisections"])
        # the flush ran SHARDED: its VM executions carry sharded=True
        stats, _gauges = profiling.stats_and_gauges()
        sharded_execs = [k for k in stats if "sharded=True" in k]

        single = [bool(r) for r in bls_backend.batch_verify_rlc(
            items, device=dev)]
        assert got == single == oracle == want, (
            f"verdict identity violated: mesh={got} single={single} "
            f"oracle={oracle} want={want}"
        )
        assert svc.metrics.mesh_fallbacks == 0, (
            f"{svc.metrics.mesh_fallbacks} mesh fallback(s): the smoke "
            "only passed on the single-device path"
        )
        # the serve-level degraded_* transitions
        degraded = [e for e in rec.events()
                    if e["kind"].startswith("degraded")]
        assert not degraded, f"degradation transitions on clean traffic: " \
            f"{[e['kind'] for e in degraded]}"
        assert svc_bisections > 0, (
            "the service flush never bisected: the corrupted item did not "
            "exercise the failed-sharded-combine path"
        )
        assert sharded_execs, (
            "no sharded VM executions recorded: the flush routed "
            "single-device and the mesh path was never exercised"
        )
        print(
            f"mesh-smoke OK: {len(items)} checks on {MESH_DEVICES} slots "
            f"of {dev}, verdicts == single-device == oracle, "
            f"{svc_bisections} bisection(s) through the sharded combine "
            f"({len(sharded_execs)} sharded VM execution shapes), "
            "0 fallbacks"
        )
        return 0
    except Exception as e:
        path = rec.dump(reason="mesh_smoke_failure")
        print(f"mesh-smoke FAIL: {type(e).__name__}: {e}")
        print(f"mesh-smoke: flight journal dumped to {path}")
        return 1


if __name__ == "__main__":
    argv = sys.argv[1:]
    sys.exit(main("cpu" if "--device" in argv
                  and argv[argv.index("--device") + 1:][:1] == ["cpu"]
                  else None))
