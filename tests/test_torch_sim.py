"""The port's simnet (consensus_specs_tpu_torch/sim/, with
bench/sim_matrix.py) against the JAX package's, on the CPU.

Every scenario of the library runs on both packages at the same seed, each
on its own phase0 minimal spec and crafted genesis, with its own
``HeadService`` and ``VerificationService`` per node (the port's with
``device="cpu"``) over its own crypto-free ``VerdictBackend``. The two
runs must give the same event-stream ``digest`` (the runner draws the same
``random.Random`` values in the same order), the same agreed head and
per-node outcomes, the same deliveries and traffic counters, and the same
light-client evidence: exact equality everywhere, no tolerance. Then
tests/test_sim.py's determinism, rescaling, metric and journal cases run
on the port.
"""
import json
from dataclasses import asdict

import pytest

from consensus_specs_tpu import sim as jsim
from consensus_specs_tpu_torch import sim as tsim
from tests.torch_threads import one_thread

one_thread()

SEED = 7

# per-scenario evidence the attack actually happened (tests/test_sim.py)
_SCENARIO_EVIDENCE = {
    "partition_heal": lambda r: r.partition_drops > 0 and r.last_heal_s > 0
    and r.sync_sends > 0,
    "latency_skew": lambda r: r.deliveries > 0,
    "lossy_links": lambda r: r.loss_drops > 0 and r.sync_sends > 0,
    "equivocation": lambda r: r.equivocations > 0,
    "withheld_orphans": lambda r: r.withheld > 0 and sum(
        p["resolved"] for p in r.per_node.values()) > 0,
    "long_range_reorg": lambda r: True,  # head-not-on-fork is in the gate
    "censored_aggregates": lambda r: r.censored > 0,
}

# the report fields that depend on the run, not on the wall clock
_OUTCOME = ("name", "nodes", "seed", "converged", "error", "head",
            "head_slot", "converged_at_s", "last_heal_s",
            "heal_to_convergence_s", "sim_end_s", "events", "messages",
            "deliveries", "transmissions", "loss_drops", "partition_drops",
            "sync_sends", "censored", "equivocations", "withheld",
            "light_clients", "proofs_served", "proofs_verified",
            "proof_failures", "proof_cache_hit_rate", "per_client",
            "diverged_samples", "digest")


@pytest.fixture(scope="module")
def worlds():
    return {"jax": jsim.build_world(), "torch": tsim.build_world()}


def _run(worlds, pkg, name, **kw):
    spec, anchor_state, anchor_block = worlds[pkg]
    mod = jsim if pkg == "jax" else tsim
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return mod.run_scenario(
        mod.get_scenario(name), spec=spec, anchor_state=anchor_state,
        anchor_block=anchor_block, **{"seed": SEED, **kw, **extra})


# per-node numbers of the wall clock, not of the run: the get_head query
# rate, and the count of service flushes, whose batch boundaries follow
# the service's max_wait_ms window (two submits a loaded host spreads
# past it reach the backend in two calls; the verdicts are the same)
_WALL_CLOCK = ("heads_per_sec", "backend_calls")


def _outcome(report):
    out = {k: getattr(report, k) for k in _OUTCOME}
    out["per_node"] = {
        n: {k: v for k, v in snap.items() if k not in _WALL_CLOCK}
        for n, snap in report.per_node.items()}
    return out


def test_worlds_and_library_equal(worlds):
    jspec, jstate, jblock = worlds["jax"]
    tspec, tstate, tblock = worlds["torch"]
    assert tstate.encode_bytes() == jstate.encode_bytes()
    assert bytes(tspec.hash_tree_root(tblock)) == \
        bytes(jspec.hash_tree_root(jblock))
    assert tsim.scenario_names() == jsim.scenario_names()
    for name in tsim.scenario_names():
        assert (asdict(tsim.get_scenario(name))
                == asdict(jsim.get_scenario(name)))
    assert set(_SCENARIO_EVIDENCE) == set(tsim.scenario_names())


@pytest.mark.parametrize("name", jsim.scenario_names())
def test_scenario_equal_on_both_packages(worlds, name):
    """The strict gate on both packages (SimDivergence would raise), then
    the digest, heads, per-node outcomes, deliveries and light-client
    evidence equal."""
    got = {pkg: _run(worlds, pkg, name) for pkg in ("jax", "torch")}
    report = got["torch"]
    assert report.converged and report.error is None
    assert report.diverged_samples > 0
    assert _SCENARIO_EVIDENCE[name](report), report.to_dict()
    for node_name, snap in report.per_node.items():
        assert snap["applied"] > 0, f"{node_name} applied nothing"
        assert snap["deferred_pending"] == 0
        assert snap["backend_calls"] > 0
    assert report.heads_per_sec_min > 0
    assert report.proofs_verified > 0 and report.proof_failures == 0
    assert _outcome(report) == _outcome(got["jax"])


def test_same_seed_same_run(worlds):
    a = _run(worlds, "torch", "partition_heal", seed=23)
    b = _run(worlds, "torch", "partition_heal", seed=23)
    assert a.digest == b.digest
    assert _outcome(a) == _outcome(b)
    c = _run(worlds, "torch", "partition_heal", seed=24)
    assert c.digest != a.digest
    assert c.digest == _run(worlds, "jax", "partition_heal", seed=24).digest


def test_with_nodes_rescales_the_attack_too():
    skewed = tsim.get_scenario("latency_skew").with_nodes(3)
    assert skewed.nodes == 3
    assert dict(skewed.latency_skew) == {2: 20.0}
    split = tsim.get_scenario("partition_heal").with_nodes(6)
    assert split.partitions[0].groups == ((0, 1, 2), (3, 4, 5))
    assert asdict(split) == asdict(
        jsim.get_scenario("partition_heal").with_nodes(6))


def test_more_nodes_still_converge_alike(worlds):
    got = {pkg: _run(worlds, pkg, "partition_heal", nodes=6)
           for pkg in ("jax", "torch")}
    assert got["torch"].converged and got["torch"].nodes == 6
    assert got["torch"].partition_drops > 0
    assert _outcome(got["torch"]) == _outcome(got["jax"])


def test_node_labelled_metrics_published(worlds):
    from consensus_specs_tpu_torch.ops import profiling

    profiling.reset()
    _run(worlds, "torch", "equivocation")
    snap = profiling.summary()
    for node in ("n0", "n3"):
        assert f"chain[{node}].head_slot" in snap
        assert f"chain[{node}].blocks" in snap
        assert f"serve[{node}].queue_depth" in snap
    assert (snap["chain[n0].head_slot"]["gauge"]
            == snap["chain[n3].head_slot"]["gauge"])
    profiling.reset()


def test_flight_journals_per_node_alike(worlds, tmp_path):
    texts = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        report = _run(worlds, pkg, "withheld_orphans", flight_dir=str(out))
        files = sorted(p.name for p in out.iterdir())
        assert files == [
            f"sim_flight_withheld_orphans_c{i}.jsonl"
            for i in range(report.light_clients)
        ] + [
            f"sim_flight_withheld_orphans_n{i}.jsonl"
            for i in range(report.nodes)
        ]
        lines = [json.loads(ln) for ln in (
            out / "sim_flight_withheld_orphans_n0.jsonl").read_text()
            .splitlines()]
        header, events = lines[0], lines[1:]
        assert header["node"] == "n0" and header["events"] > 0
        assert {"on_block", "defer"} <= {e["kind"] for e in events}
        assert all(e["node"] == "n0" for e in events)
        assert all(0.0 <= e["t"] <= report.sim_end_s for e in events)
        texts[pkg] = {f: [(e["t"], e["plane"], e["kind"])
                          for e in map(json.loads, (out / f).read_text()
                                       .splitlines()[1:])]
                      for f in files}
    assert texts["torch"] == texts["jax"]


def test_sim_matrix_bench_equal(worlds, monkeypatch):
    """The scenario-matrix bench on two scenarios: the same ``sim``
    section and converged share on both packages."""
    from consensus_specs_tpu.bench import sim_matrix as jmatrix
    from consensus_specs_tpu_torch.bench import sim_matrix as tmatrix

    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SIM_SCENARIOS",
                       "partition_heal,censored_aggregates")
    j = jmatrix.run_sim_bench()
    t = tmatrix.run_sim_bench(device="cpu")
    assert t["sim"] == j["sim"]
    for key in ("vs_baseline", "scenarios", "converged", "diverged",
                "deliveries", "nodes", "seed", "mode", "unit"):
        assert t[key] == j[key], key
    assert t["vs_baseline"] == 1.0


def test_smokes_pass_on_the_cpu(tmp_path, monkeypatch):
    """The port's sim smoke and latency smoke on CPU services."""
    from consensus_specs_tpu_torch.sim import latency_smoke, smoke

    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SIM_FLIGHT_DIR", str(tmp_path))
    report = {}
    assert smoke.main(device="cpu", report=report) == 0
    assert report["scenario"].converged
    assert report["scenario"].digest == _run(
        {"jax": jsim.build_world()}, "jax", "partition_heal").digest
    assert latency_smoke.main(device="cpu") == 0
