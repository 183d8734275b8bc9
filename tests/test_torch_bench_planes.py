"""The port's bench modes over the serving planes (mainnet, latency, soak)
against the JAX package's, on the CPU, as tests/test_torch_bench.py holds
the others: each port mode through the entry on the CPU, the JAX module
at the same knobs and seeds, every deterministic field equal: the
mainnet sections' gates and the localized committee, and the latency and
soak runs' scenario digests, gates and health verdict.
"""
import os

from tests.test_torch_bench import _digests, _env, _port_line
from tests.torch_threads import one_thread

one_thread()


MAINNET = {"CONSENSUS_SPECS_TPU_SCALE_VALIDATORS": "8192",
           "CONSENSUS_SPECS_TPU_SCALE_SIM_VALIDATORS": "64",
           "CONSENSUS_SPECS_TPU_SCALE_FLEET_WORKERS": "1"}


def test_mainnet_sections_equal():
    from consensus_specs_tpu.bench.mainnet import run_mainnet_bench

    got = _port_line("mainnet", MAINNET)
    with _env(MAINNET):
        want = run_mainnet_bench()
    assert got["ok"] is want["ok"] is True
    assert set(got["mainnet"]) == set(want["mainnet"])
    for name, section in want["mainnet"].items():
        assert got["mainnet"][name]["ok"] is section["ok"] is True, name
    g, w = got["mainnet"], want["mainnet"]
    for k in ("planted", "localized", "bisections", "extra_final_exps"):
        assert g["bad_committee"][k] == w["bad_committee"][k], k
    assert g["bad_committee"]["localized"] == [1]
    for k in ("committees_per_slot", "committee_size",
              "attestations_per_slot", "final_exps_per_slot",
              "pubkey_hit_rate"):
        assert g["slot_replay"][k] == w["slot_replay"][k], k
    for k in ("committees_per_slot", "censored_validators", "digest"):
        assert g["censored_sim"][k] == w["censored_sim"][k], k
    assert g["affinity"] == w["affinity"]


LATENCY = {"LATENCY_SCENARIOS": "latency_skew"}


def test_latency_matrix_equal():
    """Every (scenario, flush policy) run's digest and convergence, and
    each scenario's gate."""
    from consensus_specs_tpu.bench import latency_pipeline as jlp
    from consensus_specs_tpu_torch.bench import latency_pipeline as tlp

    with _digests(tlp) as tseen:
        got = _port_line("latency", LATENCY)
    with _env(LATENCY), _digests(jlp) as jseen:
        want = jlp.run_latency_bench()
    assert tseen == jseen and len(tseen) == 3
    assert all(conv for _, conv in tseen)
    assert set(got["latency"]) == set(want["latency"]) == {"latency_skew"}
    for name, row in want["latency"].items():
        assert got["latency"][name]["converged"] is row["converged"] is True
        assert got["latency"][name]["ok"] is row["ok"]
    assert got["objective_ms"] == want["objective_ms"]


def test_soak_equal(tmp_path):
    """The soak on 1 verdict worker of each package: the scenario's digest,
    convergence, slots, deliveries and the health verdict."""
    from consensus_specs_tpu.bench import soak as jsoak
    from consensus_specs_tpu_torch.bench import soak as tsoak

    # the soak arms the timeseries plane (``os.environ.setdefault`` of
    # CONSENSUS_SPECS_TPU_TS, in both packages): set here, it is taken back
    # after each run instead of reaching every later worker process
    knobs = {"CONSENSUS_SPECS_TPU_SOAK_EPOCHS": "4",
             "CONSENSUS_SPECS_TPU_SOAK_WORKERS": "1",
             "CONSENSUS_SPECS_TPU_SOAK_DIR": str(tmp_path / "torch"),
             "CONSENSUS_SPECS_TPU_TS": "1"}
    with _digests(tsoak) as tseen:
        got = _port_line("soak", knobs)
    knobs["CONSENSUS_SPECS_TPU_SOAK_DIR"] = str(tmp_path / "jax")
    with _env(knobs), _digests(jsoak) as jseen:
        want = jsoak.run_soak_bench()
    assert tseen == jseen and len(tseen) == 1
    for k in ("converged", "slots", "warmup_slots", "deliveries", "epochs",
              "vs_baseline"):
        assert got[k] == want[k], k
    assert got["vs_baseline"] == 1.0
    gh, wh = got["health"], want["health"]
    assert gh["gate"]["ok"] is wh["gate"]["ok"] is True
    assert gh["slots_observed"] == wh["slots_observed"]
    assert (gh["aggregate"]["unexplained_reorgs"]
            == wh["aggregate"]["unexplained_reorgs"] == 0)
    assert os.path.exists(got["soak"]["timeseries"]["path"])
