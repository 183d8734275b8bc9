"""simnet: deterministic adversarial multi-node gossip simulation (the
port's copy of consensus_specs_tpu/sim/).

N independent ``HeadService`` instances — each with its own store,
``VerificationService``, and node-labelled observability — exchanging
blocks and attestation aggregates over a simulated gossip fabric with
per-link latency, loss, scheduled partitions, and an adversary
(equivocating proposals, withheld-block orphan releases, censored and
invalid aggregates, long-range reorg attempts). The core gate is
differential convergence: after every partition heals and the event
queue drains, every honest node's ``get_head`` must be bit-identical to
``spec.get_head`` on the union view, and to each other.

Entry points: ``run_scenario`` (one scenario, strict gate),
``SCENARIOS`` (the named scenario library), ``build_world`` (the shared
spec + crafted genesis), and ``bench/sim_matrix.run_sim_bench`` for the
full matrix. It is crypto-free: every node's ``VerificationService``
answers through the ``VerdictBackend`` and launches no kernel, whatever
its device (the card unless the caller asks for ``device="cpu"``).
"""
from .fabric import EventQueue, Fabric, Message, PartitionWindow
from .node import SimNode
from .runner import (
    ScenarioReport,
    SimDivergence,
    build_world,
    run_scenario,
)
from .scenarios import SCENARIOS, Scenario, get_scenario, scenario_names

__all__ = [
    "EventQueue",
    "Fabric",
    "Message",
    "PartitionWindow",
    "SCENARIOS",
    "Scenario",
    "ScenarioReport",
    "SimDivergence",
    "SimNode",
    "build_world",
    "get_scenario",
    "run_scenario",
    "scenario_names",
]
