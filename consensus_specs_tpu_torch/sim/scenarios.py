"""The named scenario library: every attack class the simnet gate runs (the
port's copy of consensus_specs_tpu/sim/scenarios.py).

Each scenario is a frozen config the runner turns into one deterministic
discrete-event run: honest proposal/attestation traffic plus the
scenario's fault injection (``serve/load.py::plan_gossip_faults`` kinds)
and network shaping (partitions, latency skew, loss). ``review_finding``
maps the class back to the Security Review of Ethereum Beacon Clients
(PAPERS.md) finding it reproduces — the full mapping lives in
``docs/simnet_threat_model.md``.

Scheduling invariant every scenario must respect: fork-choice drops
attestations whose target epoch is older than the previous epoch, so any
disruption delaying epoch-``e`` aggregates (partition, withholding,
laggard links) must resolve while the cluster clock is still inside
epoch ``e+1`` — otherwise SOME nodes apply a vote that others
legitimately refuse, which is a real consensus hazard the convergence
gate will (deterministically) flag, not a sim artifact.
"""
from dataclasses import dataclass, replace
from typing import Dict, Tuple

from .fabric import PartitionWindow

__all__ = ["Scenario", "SCENARIOS", "scenario_names", "get_scenario"]


@dataclass(frozen=True)
class Scenario:
    """One named adversarial network configuration."""

    name: str
    description: str
    review_finding: str  # Beacon-client security review mapping (docs/)
    nodes: int = 4
    epochs: int = 3
    events_per_epoch: int = 12  # attestation aggregates per epoch
    fork_rate: float = 0.2      # chance of an extra honest sibling per slot
    # link model
    base_latency: float = 0.05
    jitter: float = 0.02
    latency_skew: Tuple[Tuple[int, float], ...] = ()
    loss_rate: float = 0.0
    # schedule (slot units)
    partitions: Tuple[PartitionWindow, ...] = ()
    sync_interval_slots: float = 0.0  # periodic anti-entropy; 0 = off
    # fault plan rates (plan_gossip_faults)
    invalid_rate: float = 0.0
    orphan_rate: float = 0.0
    equivocation_rate: float = 0.0
    censor_rate: float = 0.0
    # adversary extras
    long_range_fork: int = 0  # private-fork length released late
    # read-only light clients fetching + verifying head proofs from full
    # nodes (sim/node.py::LightClientNode); their proof correctness is a
    # convergence-gated property on every scenario
    light_clients: int = 2

    def with_nodes(self, nodes: int) -> "Scenario":
        """The same scenario rescaled to ``nodes`` participants. Partition
        groups re-split into two halves, and latency-skew targets remap
        onto surviving indices — shrinking the cluster must never
        silently disarm the attack the scenario exists to run."""
        if nodes == self.nodes:
            return self
        parts = tuple(
            replace(
                w,
                groups=(tuple(range(nodes // 2)),
                        tuple(range(nodes // 2, nodes))),
            )
            for w in self.partitions
        )
        skew = tuple((min(i, nodes - 1), m) for i, m in self.latency_skew)
        return replace(self, nodes=nodes, partitions=parts,
                       latency_skew=skew)


def _two_way(form_slot: float, heal_slot: float,
             nodes: int = 4) -> PartitionWindow:
    half = nodes // 2
    return PartitionWindow(
        form_slot=form_slot, heal_slot=heal_slot,
        groups=(tuple(range(half)), tuple(range(half, nodes))),
    )


_ALL = (
    Scenario(
        name="partition_heal",
        description="two-way network split mid-epoch-0, healed early in "
                    "epoch 1; both sides keep proposing and voting, then "
                    "reconcile over the heal-time sync",
        review_finding="network-partition / eclipse resilience "
                       "(fork-choice recovery after isolation)",
        partitions=(_two_way(form_slot=2.0, heal_slot=9.0),),
        invalid_rate=0.05,
    ),
    Scenario(
        name="latency_skew",
        description="one laggard node on ~20x link latency: every message "
                    "arrives late (often deferred), none may be lost to "
                    "reordering",
        review_finding="slow-peer handling / message reordering "
                       "(delay-consideration correctness)",
        latency_skew=((3, 20.0),),
        invalid_rate=0.05,
    ),
    Scenario(
        name="lossy_links",
        description="15% i.i.d. transmission loss with periodic reliable "
                    "anti-entropy sync every half epoch — gossip "
                    "redundancy plus req/resp recovery must still "
                    "converge",
        review_finding="unreliable gossip transport (message-loss "
                       "tolerance bounds)",
        loss_rate=0.15,
        sync_interval_slots=4.0,
    ),
    Scenario(
        name="equivocation",
        description="adversarial proposer equivocates: conflicting twin "
                    "blocks at one slot published to opposite halves of "
                    "the network; honest gossip spreads both and fork "
                    "choice must settle identically everywhere",
        review_finding="proposer equivocation / slashable double "
                       "proposals (fork-choice tie handling)",
        equivocation_rate=0.2,
        invalid_rate=0.05,
    ),
    Scenario(
        name="withheld_orphans",
        description="adversary withholds proposals their committees vote "
                    "for, releasing them slots later: every node must "
                    "defer the orphan votes and resolve them on release, "
                    "whatever order the release reaches it",
        review_finding="block-withholding / orphaned-attestation handling "
                       "(deferral-buffer correctness)",
        orphan_rate=0.25,
    ),
    Scenario(
        name="long_range_reorg",
        description="adversary releases a private zero-weight fork built "
                    "from genesis at the last epoch — an attempted "
                    "long-range reorg the LMD weights must shrug off on "
                    "every node",
        review_finding="long-range / alternative-history attack "
                       "(weak-subjectivity boundary behavior)",
        long_range_fork=8,
        invalid_rate=0.05,
    ),
    Scenario(
        name="censored_aggregates",
        description="adversarial aggregator censors a share of committee "
                    "aggregates outright (never published): heads must "
                    "still agree, with the censored weight visibly "
                    "missing from the matrix report",
        review_finding="censorship by aggregators / validator-privacy "
                       "metadata leaks (liveness under suppression)",
        censor_rate=0.25,
        invalid_rate=0.05,
    ),
)

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in _ALL}


def scenario_names() -> Tuple[str, ...]:
    return tuple(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(SCENARIOS)}"
        ) from None
