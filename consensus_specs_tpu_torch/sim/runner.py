"""Scenario runner: script -> discrete-event run -> convergence gate (the
port's copy of consensus_specs_tpu/sim/runner.py; the same
``random.Random`` draws in the same order, so a scenario's ``digest`` at a
seed is the JAX package's).

One scenario run has three phases:

1. **Script building** (pure, pre-run): an honest chain of one proposal
   per slot (plus fork siblings at ``fork_rate``), real spec committees
   derived from the one crafted genesis state, and an attestation
   aggregate stream whose per-event faults come from
   ``serve/load.py::plan_gossip_faults`` — ``invalid_sig`` carries
   ``BAD_SIGNATURE``, ``orphan`` votes for a withheld adversarial
   sibling released slots later, ``equivocation`` pairs the slot's
   proposal with a conflicting twin published to the other half of the
   network, ``censored_agg`` is never published at all. Scenarios may
   additionally arm a private long-range fork released in the last
   epoch.

2. **The event loop**: a ``(time, seq)`` heap drains publishes,
   deliveries (flood gossip with first-receipt rebroadcast), partition
   forms/heals (heal triggers a reliable re-announcement sync, the
   req/resp recovery channel), and periodic anti-entropy. Every node is
   a full :class:`~.node.SimNode` — real
   ``HeadService`` + ``VerificationService`` per node. Head agreement is
   sampled after every delivery, which is what the heal-to-convergence
   latency is measured from.

3. **The differential convergence gate** (strict mode raises
   :class:`SimDivergence`): after the final sync and queue drain, every
   node must know the same block set, hold identical latest-message
   tables, and answer the same ``get_head`` — and that head must be
   bit-identical to ``spec.get_head`` recomputed BOTH on each node's own
   store and on a union store rebuilt from scratch. When the scenario
   runs ``light_clients`` (default 2), the gate grows a proof-plane
   layer: every client must have verified at least one served head
   proof, report zero verification failures, and sit at the agreed
   head — a lying or diverged proof server is a convergence failure,
   not just a metric. The same scripted run under the same seed replays
   the identical event sequence (``digest`` pins it).
"""
import hashlib
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..serve.load import BAD_SIGNATURE, plan_gossip_faults
from . import adversary
from .fabric import EventQueue, Fabric, Message
from .node import LightClientNode, SimNode
from .scenarios import Scenario

__all__ = [
    "ScenarioReport", "SimDivergence", "build_world", "run_scenario",
]

# env knobs (documented in the README env reference)
NODES_ENV = "CONSENSUS_SPECS_TPU_SIM_NODES"
SEED_ENV = "CONSENSUS_SPECS_TPU_SIM_SEED"
SCENARIOS_ENV = "CONSENSUS_SPECS_TPU_SIM_SCENARIOS"
FLIGHT_DIR_ENV = "CONSENSUS_SPECS_TPU_SIM_FLIGHT_DIR"
EVENTS_ENV = "CONSENSUS_SPECS_TPU_SIM_EVENTS"


class SimDivergence(AssertionError):
    """An honest node's view failed the differential convergence gate."""


@dataclass
class ScenarioReport:
    """Everything one scenario run proves (and the numbers around it)."""

    name: str
    nodes: int
    seed: int
    converged: bool
    error: Optional[str] = None
    head: str = ""            # agreed head root (hex prefix)
    head_slot: int = 0
    converged_at_s: float = 0.0       # sim time agreement became stable
    last_heal_s: float = 0.0          # sim time of the last heal (0: none)
    # first head agreement at-or-after the last heal, minus the heal time
    # (no partitions: time to the first agreement at all) — the recovery
    # latency the scenario matrix reports
    heal_to_convergence_s: float = 0.0
    sim_end_s: float = 0.0
    wall_s: float = 0.0
    events: Dict[str, int] = field(default_factory=dict)   # fault plan mix
    messages: int = 0
    deliveries: int = 0
    transmissions: int = 0
    loss_drops: int = 0
    partition_drops: int = 0
    sync_sends: int = 0
    censored: int = 0
    equivocations: int = 0
    withheld: int = 0
    per_node: Dict[str, dict] = field(default_factory=dict)
    heads_per_sec_min: float = 0.0
    heads_per_sec_mean: float = 0.0
    # the light-client proof plane: read-only clients fetching
    # head proofs at heal/sync points + one final round; their verified
    # proof-backed heads are convergence-gated (layer 5)
    light_clients: int = 0
    proofs_served: int = 0
    proofs_verified: int = 0
    proof_failures: int = 0
    proof_cache_hit_rate: float = 0.0
    per_client: Dict[str, dict] = field(default_factory=dict)
    # deliveries observed while honest heads DISAGREED — evidence the
    # scenario genuinely disturbed the network before it converged
    diverged_samples: int = 0
    digest: str = ""          # event-stream hash: the determinism pin

    def to_dict(self) -> dict:
        out = dict(self.__dict__)
        out["per_node"] = dict(self.per_node)
        out["per_client"] = dict(self.per_client)
        out["events"] = dict(self.events)
        return out


def build_world(validators: Optional[int] = None):
    """(spec, anchor_state, anchor_block) every scenario shares: the
    minimal-preset phase0 spec and one crafted genesis state (the
    committee source; 64 validators by default — 2 committees of 4 per
    slot). Reusable read-only across scenario runs: each node's store
    copies it on construction."""
    from ..builder import build_spec_module
    from ..test.helpers.genesis import create_genesis_state

    spec = build_spec_module("phase0", "minimal")
    if validators is None:
        validators = int(spec.SLOTS_PER_EPOCH) * 8
    anchor_state = create_genesis_state(
        spec, [spec.MAX_EFFECTIVE_BALANCE] * validators,
        spec.MAX_EFFECTIVE_BALANCE)
    anchor_block = spec.BeaconBlock(state_root=anchor_state.hash_tree_root())
    return spec, anchor_state, anchor_block


# -- script building ----------------------------------------------------------


class _Script:
    """The pre-computed run: blocks, committees, attestation events, and
    the adversary's schedule — everything the event loop publishes."""

    def __init__(self, spec, anchor_state, anchor_block, scenario: Scenario,
                 rng: random.Random, events_per_epoch: int):
        self.spec = spec
        self.scenario = scenario
        sps = int(spec.config.SECONDS_PER_SLOT)
        slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
        self.total_slots = slots_per_epoch * scenario.epochs - 1
        self.anchor_root = spec.hash_tree_root(anchor_block)

        # -- honest chain: one proposal per slot (+ fork siblings) -----------
        self.blocks: Dict[bytes, object] = {
            bytes(self.anchor_root): anchor_block}
        self.parent: Dict[bytes, bytes] = {}
        self.canonical: Dict[int, bytes] = {0: bytes(self.anchor_root)}
        self.block_publishes: List[Tuple[float, int, Message]] = []
        prev = bytes(self.anchor_root)
        for slot in range(1, self.total_slots + 1):
            block = spec.BeaconBlock(
                slot=slot, proposer_index=0, parent_root=spec.Root(prev),
                state_root=rng.getrandbits(256).to_bytes(32, "little"))
            root = self._add_block(block, prev)
            self.canonical[slot] = root
            t = slot * sps + rng.uniform(0.0, 0.3)
            origin = (slot - 1) % scenario.nodes
            self.block_publishes.append(
                (t, origin, Message(f"b:{root.hex()[:16]}", "block", block)))
            if rng.random() < scenario.fork_rate and slot >= 2:
                # an honest sibling forking off the grandparent: a real
                # two-branch tie the vote weights must settle
                gp = self.parent[prev] if slot > 2 else bytes(self.anchor_root)
                sib = spec.BeaconBlock(
                    slot=slot, proposer_index=1, parent_root=spec.Root(gp),
                    state_root=rng.getrandbits(256).to_bytes(32, "little"))
                sroot = self._add_block(sib, gp)
                self.block_publishes.append(
                    (t + rng.uniform(0.0, 0.3), (slot) % scenario.nodes,
                     Message(f"b:{sroot.hex()[:16]}", "block", sib)))
            prev = root

        # -- committees from the one crafted state ---------------------------
        self.committees: Dict[Tuple[int, int], List[int]] = {}
        committee_slots: List[List[Tuple[int, int]]] = []
        state = anchor_state.copy()
        for epoch in range(scenario.epochs):
            start = spec.compute_start_slot_at_epoch(spec.Epoch(epoch))
            if state.slot < start:
                spec.process_slots(state, start)
            per_slot = int(spec.get_committee_count_per_slot(
                state, spec.Epoch(epoch)))
            coords = []
            for s in range(int(start),
                           min(int(start) + slots_per_epoch,
                               self.total_slots + 1)):
                for idx in range(per_slot):
                    self.committees[(s, idx)] = [
                        int(v) for v in spec.get_beacon_committee(
                            state, spec.Slot(s), spec.CommitteeIndex(idx))]
                    coords.append((s, idx))
            committee_slots.append(coords)

        # -- attestation events + the adversary's schedule -------------------
        self.att_publishes: List[Tuple[float, int, Message]] = []
        self.adversary_sends: List[Tuple[float, Tuple[int, ...], Message]] = []
        self.plan_counts: Dict[str, int] = {}
        self.censored = 0
        self.equivocations = 0
        self.withheld = 0
        att_seq = 0
        for epoch in range(scenario.epochs):
            plan = plan_gossip_faults(
                rng, events_per_epoch,
                invalid_rate=scenario.invalid_rate,
                orphan_rate=scenario.orphan_rate,
                equivocation_rate=scenario.equivocation_rate,
                censor_rate=scenario.censor_rate)
            for kind, count in plan.counts().items():
                self.plan_counts[kind] = self.plan_counts.get(kind, 0) + count
            # one committee votes at most once per epoch: every validator
            # contributes one latest message per epoch, so latest-message
            # tables are delivery-order independent (no double votes)
            coords = list(committee_slots[epoch])
            rng.shuffle(coords)
            for e in range(min(events_per_epoch, len(coords))):
                slot, idx = coords[e]
                if slot < 1:
                    continue  # genesis-slot committees sit out
                fault = plan[e]
                vote_root = self.canonical[slot]
                if fault == "orphan":
                    # adversarial proposer withholds a sibling the
                    # committee votes for; released ~2.5 slots later to
                    # one node and gossiped outward from there
                    held = adversary.withheld_sibling(
                        spec, spec.Root(self.canonical[slot - 1]), slot, rng)
                    vote_root = self._add_block(held,
                                                self.canonical[slot - 1])
                    self.withheld += 1
                    release_t = (slot + 1) * sps + 2.5 * sps
                    self.adversary_sends.append((
                        release_t, (rng.randrange(scenario.nodes),),
                        Message(f"b:{vote_root.hex()[:16]}", "block", held)))
                elif fault == "equivocation":
                    twin = adversary.equivocating_twin(
                        spec, self.blocks[self.canonical[slot]], rng)
                    troot = self._add_block(
                        twin, self.parent[self.canonical[slot]])
                    self.equivocations += 1
                    half = tuple(range(scenario.nodes // 2, scenario.nodes))
                    self.adversary_sends.append((
                        slot * sps + rng.uniform(0.0, 0.3), half,
                        Message(f"b:{troot.hex()[:16]}", "block", twin)))
                att = self._build_attestation(
                    epoch, slot, idx, vote_root,
                    bad_sig=(fault == "invalid_sig"))
                msg = Message(f"a:{att_seq}", "atts", att)
                att_seq += 1
                if fault == "censored_agg":
                    # the adversarial aggregator never publishes it: the
                    # votes vanish from every honest view (and from the
                    # union oracle — that is what censorship costs)
                    self.censored += len(self.committees[(slot, idx)])
                    continue
                t = (slot + 1) * sps + rng.uniform(0.0, 0.3)
                self.att_publishes.append(
                    (t, (slot + idx) % scenario.nodes, msg))

        # -- private long-range fork -----------------------------------------
        if scenario.long_range_fork:
            fork = adversary.private_fork(
                spec, self.anchor_root, 0, scenario.long_range_fork, rng)
            self.private_fork_roots = [r for r, _ in fork]
            release_t = ((scenario.epochs - 1) * slots_per_epoch) * sps + 1.0
            victim = (rng.randrange(scenario.nodes),)
            for i, (root, block) in enumerate(fork):
                self.parent[root] = (bytes(self.anchor_root) if i == 0
                                     else fork[i - 1][0])
                self.blocks[root] = block
                self.adversary_sends.append((
                    release_t + i * 0.2, victim,
                    Message(f"b:{root.hex()[:16]}", "block", block)))
        else:
            self.private_fork_roots = []

    def _add_block(self, block, parent_root: bytes) -> bytes:
        root = bytes(self.spec.hash_tree_root(block))
        self.blocks[root] = block
        self.parent[root] = parent_root
        return root

    def ancestor_at(self, root: bytes, slot: int) -> bytes:
        while int(self.blocks[root].slot) > slot:
            root = self.parent[root]
        return root

    def _build_attestation(self, epoch: int, slot: int, idx: int,
                           vote_root: bytes, bad_sig: bool):
        spec = self.spec
        target_slot = int(spec.compute_start_slot_at_epoch(spec.Epoch(epoch)))
        target_root = self.ancestor_at(vote_root, target_slot)
        committee = self.committees[(slot, idx)]
        data = spec.AttestationData(
            slot=slot, index=idx,
            beacon_block_root=spec.Root(vote_root),
            source=spec.Checkpoint(),
            target=spec.Checkpoint(epoch=epoch, root=spec.Root(target_root)),
        )
        bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](
            [1] * len(committee))
        signature = (BAD_SIGNATURE if bad_sig
                     else (b"\x51" + target_root[:15] + vote_root[:16]) * 3)
        return spec.Attestation(data=data, aggregation_bits=bits,
                                signature=signature)


# -- the event loop + gate ----------------------------------------------------


def run_scenario(scenario: Scenario, *, spec=None, anchor_state=None,
                 anchor_block=None, seed: int = 7,
                 nodes: Optional[int] = None,
                 events_per_epoch: Optional[int] = None,
                 strict: bool = True, flight_dir: Optional[str] = None,
                 query_rounds: int = 512,
                 backend_factory=None,
                 service_kwargs: Optional[dict] = None,
                 head_kwargs: Optional[dict] = None,
                 light_clients: Optional[int] = None,
                 slot_hook=None, device=None) -> ScenarioReport:
    """Run one scenario end to end and gate it. ``strict`` raises
    :class:`SimDivergence` on any convergence failure; bench mode passes
    ``strict=False`` and reads ``report.converged``/``report.error``.
    ``flight_dir`` dumps one JSONL flight journal per node (always on
    failure paths when set — the CI artifact). ``service_kwargs`` /
    ``head_kwargs`` override every node's VerificationService /
    HeadService knobs (the latency bench's deadline-flush and
    speculative-apply A/B runs) — the scenario script and the gate are
    untouched by either. ``light_clients`` overrides the scenario's
    read-only light-client count (they fetch proofs OUTSIDE the event
    queue, so the determinism digest is unchanged). ``slot_hook``
    is called as ``slot_hook(slot, sim_nodes)`` once per
    simulated slot boundary in slot order — the soak's per-slot health
    ledger sampling point. Pure reads only: the hook runs outside the
    event queue and must not publish, so the digest is unchanged.
    ``device`` is every node service's device (None: the CUDA card); the
    services answer through crypto-free backends and launch no kernel."""
    from ..utils import bls

    if spec is None:
        spec, anchor_state, anchor_block = build_world()
    if nodes is not None:
        scenario = scenario.with_nodes(nodes)
    if events_per_epoch is None:
        events_per_epoch = int(os.environ.get(
            EVENTS_ENV, str(scenario.events_per_epoch)))
    assert scenario.nodes >= 2

    sps = int(spec.config.SECONDS_PER_SLOT)
    script_rng = random.Random((seed * 1_000_003) ^ _name_key(scenario.name))
    fabric_rng = random.Random((seed * 7_368_787) ^ _name_key(scenario.name))
    script = _Script(spec, anchor_state, anchor_block, scenario, script_rng,
                     events_per_epoch)

    fabric = Fabric(
        scenario.nodes, fabric_rng,
        base_latency=scenario.base_latency, jitter=scenario.jitter,
        latency_skew=dict(scenario.latency_skew),
        loss_rate=scenario.loss_rate)
    queue = EventQueue()
    clock_box = {"now": 0.0}
    sim_nodes: List[SimNode] = []
    was_active = bls.bls_active
    bls.bls_active = True  # verdicts must flow through the services
    t_wall = time.perf_counter()
    try:
        for i in range(scenario.nodes):
            # backend_factory (fleet replay): per-node verdict backends
            # that cross a real process boundary instead of staying
            # in-process — the scenario script and gate are unchanged
            sim_nodes.append(SimNode(
                i, spec, anchor_state, anchor_block, anchor_state,
                sim_clock=lambda: clock_box["now"],
                backend=(backend_factory(f"n{i}")
                         if backend_factory is not None else None),
                service_kwargs=service_kwargs, head_kwargs=head_kwargs,
                device=device))
        n_clients = (scenario.light_clients if light_clients is None
                     else light_clients)
        clients = [
            LightClientNode(i, spec, anchor_state,
                            sim_clock=lambda: clock_box["now"])
            for i in range(n_clients)]
        fetch_rounds = [0]

        def client_fetch_round() -> None:
            """Every light client fetches from a deterministic full node
            (rotating per round). Pure reads — no queue events, so the
            event-stream digest is untouched."""
            if not clients:
                return
            r = fetch_rounds[0]
            fetch_rounds[0] += 1
            for client in clients:
                client.fetch(sim_nodes[(client.index + r) % len(sim_nodes)])

        # -- schedule ---------------------------------------------------------
        for t, origin, msg in script.block_publishes:
            queue.push(t, "publish", origin=origin, msg=msg)
        for t, origin, msg in script.att_publishes:
            queue.push(t, "publish", origin=origin, msg=msg)
        for t, targets, msg in script.adversary_sends:
            queue.push(t, "adversary", targets=targets, msg=msg)
        for window in scenario.partitions:
            queue.push(window.form_slot * sps, "partition",
                       groups=window.groups)
            queue.push(window.heal_slot * sps, "heal")
        if scenario.sync_interval_slots:
            t = scenario.sync_interval_slots * sps
            t_last = (script.total_slots + 1) * sps
            while t < t_last:
                queue.push(t, "sync")
                t += scenario.sync_interval_slots * sps
        # the final reliable sync: the post-disruption reconciliation
        # every real network does over req/resp once gossip quiesces —
        # scheduled strictly after the last scripted publication (late
        # adversary releases included), so nothing can slip past it
        schedule_end = max(
            (t for t, *_ in script.block_publishes + script.att_publishes
             + script.adversary_sends), default=0.0)
        t_end = max((script.total_slots + 1) * sps, schedule_end + 1.0) + 1.0
        queue.push(t_end, "sync")

        # -- drain ------------------------------------------------------------
        digest = hashlib.sha256()
        samples: List[Tuple[float, bool]] = []
        last_heal = 0.0
        deliveries = 0
        last_hook_slot = 0

        def heads_equal() -> bool:
            head0 = sim_nodes[0].get_head()
            return all(n.get_head() == head0 for n in sim_nodes[1:])

        def fire_slot_hook(up_to_t: float) -> None:
            # every crossed slot boundary fires exactly once, in order —
            # a quiet stretch (no events for several slots) still
            # produces one health row per slot
            nonlocal last_hook_slot
            if slot_hook is None:
                return
            cur = int(up_to_t // sps)
            while last_hook_slot < cur:
                last_hook_slot += 1
                slot_hook(last_hook_slot, sim_nodes)

        while True:
            ev = queue.pop()
            if ev is None:
                break
            clock_box["now"] = ev.time
            fire_slot_hook(ev.time)
            digest.update(f"{ev.time:.6f}|{ev.kind}".encode())
            if ev.kind == "publish":
                origin, msg = ev.data["origin"], ev.data["msg"]
                digest.update(f"|{msg.mid}|{origin}".encode())
                node = sim_nodes[origin]
                node.advance_clock(ev.time)
                if node.receive(msg):
                    fabric.broadcast(queue, ev.time, origin, msg)
                samples.append((ev.time, heads_equal()))
            elif ev.kind == "deliver":
                dst, msg = ev.data["dst"], ev.data["msg"]
                digest.update(f"|{msg.mid}|{dst}".encode())
                node = sim_nodes[dst]
                node.advance_clock(ev.time)
                deliveries += 1
                fabric.deliveries += 1
                if node.receive(msg):
                    fabric.broadcast(queue, ev.time, dst, msg)
                samples.append((ev.time, heads_equal()))
            elif ev.kind == "adversary":
                # adversary unicasts ride OUTSIDE the fabric by design:
                # a direct dial to the chosen victims, immune to honest
                # partitions and loss (counted as transmissions so the
                # report's delivery/transmission ledger still reconciles)
                msg = ev.data["msg"]
                for dst in ev.data["targets"]:
                    digest.update(f"|{msg.mid}|adv{dst}".encode())
                    fabric.transmissions += 1
                    queue.push(ev.time + 0.01 * (dst + 1), "deliver",
                               dst=dst, src=None, msg=msg, reliable=True)
            elif ev.kind == "partition":
                fabric.set_partition(ev.data["groups"])
            elif ev.kind == "heal":
                fabric.heal()
                last_heal = ev.time
                _sync(queue, fabric, sim_nodes, ev.time)
                client_fetch_round()
            elif ev.kind == "sync":
                _sync(queue, fabric, sim_nodes, ev.time)
                client_fetch_round()

        # final ticks: unlock any time-gated deferrals and settle clocks
        # (past the last processed event — sync-chained deliveries can
        # land after t_end)
        t_final = max(clock_box["now"], t_end) + 2 * sps
        clock_box["now"] = t_final
        for node in sim_nodes:
            node.advance_clock(t_final)
        fire_slot_hook(t_final)
        samples.append((t_final, heads_equal()))
        # the final proof round: with heads settled, every client's
        # proof-backed head must land on THE head (gate layer 5)
        client_fetch_round()

        # -- gate -------------------------------------------------------------
        report = ScenarioReport(
            name=scenario.name, nodes=scenario.nodes, seed=seed,
            converged=False,
            last_heal_s=last_heal,
            sim_end_s=t_final,
            events=dict(script.plan_counts),
            messages=len(script.block_publishes) + len(script.att_publishes)
            + len(script.adversary_sends),
            deliveries=deliveries,
            transmissions=fabric.transmissions,
            loss_drops=fabric.loss_drops,
            partition_drops=fabric.partition_drops,
            sync_sends=fabric.sync_sends,
            censored=script.censored,
            equivocations=script.equivocations,
            withheld=script.withheld,
        )
        error = None
        try:
            _convergence_gate(spec, anchor_state, anchor_block, sim_nodes,
                              script, clients)
        except SimDivergence as exc:
            error = str(exc)

        # agreement timeline: stability = start of the trailing all-equal
        # run; recovery = first agreement at-or-after the last heal (the
        # backlog-reconciliation latency, not steady-state gossip skew)
        converged_at = samples[-1][0]
        for t, equal in reversed(samples):
            if not equal:
                break
            converged_at = t
        report.converged_at_s = round(converged_at, 3)
        first_agree = next(
            (t for t, equal in samples if equal and t >= last_heal),
            converged_at)
        report.heal_to_convergence_s = round(
            max(0.0, first_agree - last_heal), 3)
        report.diverged_samples = sum(1 for _, equal in samples if not equal)

        # per-node serving rate: how fast each node answers get_head
        rates = []
        for node in sim_nodes:
            tq = time.perf_counter()
            for _ in range(query_rounds):
                node.get_head()
            dt = time.perf_counter() - tq
            rates.append(query_rounds / dt if dt > 0 else 0.0)
            report.per_node[node.name] = node.snapshot()
            report.per_node[node.name]["heads_per_sec"] = round(rates[-1], 2)
        report.heads_per_sec_min = round(min(rates), 2)
        report.heads_per_sec_mean = round(sum(rates) / len(rates), 2)

        # proof-plane ledger: per-client verdict counters + the serving
        # side's cache economics aggregated across nodes
        report.light_clients = len(clients)
        for client in clients:
            report.per_client[client.name] = client.snapshot()
        report.proofs_verified = sum(c.verified for c in clients)
        report.proof_failures = sum(c.failures for c in clients)
        served = hits = joins = 0
        for node in sim_nodes:
            if node._proofs is None:
                continue
            m = node._proofs.metrics
            served += m.served
            hits += m.cache_hits
            joins += m.inflight_joins
        report.proofs_served = served
        report.proof_cache_hit_rate = round(
            (hits + joins) / served, 4) if served else 0.0

        head0 = sim_nodes[0].get_head()
        report.head = head0.hex()[:16]
        report.head_slot = sim_nodes[0].head.head_slot
        report.digest = digest.hexdigest()[:16]
        report.wall_s = round(time.perf_counter() - t_wall, 3)
        report.converged = error is None
        report.error = error

        if flight_dir:
            _dump_flights(flight_dir, scenario.name, sim_nodes, clients)
        if error is not None and strict:
            raise SimDivergence(
                f"scenario {scenario.name!r} (nodes={scenario.nodes}, "
                f"seed={seed}): {error}")
        return report
    finally:
        for node in sim_nodes:
            node.close()
        bls.bls_active = was_active


def _name_key(name: str) -> int:
    """Stable per-scenario rng salt (hash() is seed-randomized)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")


def _sync(queue: EventQueue, fabric: Fabric, sim_nodes: List[SimNode],
          t: float) -> None:
    """Reliable re-announcement: every node offers everything it knows to
    every reachable peer that lacks it (loss-exempt — this is the
    req/resp channel, not gossip). In-flight races resolve via receive
    dedup."""
    for src_node in sim_nodes:
        for dst_node in sim_nodes:
            if src_node.index == dst_node.index:
                continue
            if not fabric.reachable(src_node.index, dst_node.index):
                continue
            for msg in src_node.known:
                if not dst_node.knows(msg.mid):
                    fabric.transmit(queue, t, src_node.index,
                                    dst_node.index, msg, reliable=True)


def _dump_flights(flight_dir: str, scenario_name: str,
                  sim_nodes: List[SimNode],
                  clients: List[LightClientNode] = ()) -> None:
    os.makedirs(flight_dir, exist_ok=True)
    for node in list(sim_nodes) + list(clients):
        node.recorder.dump(
            os.path.join(flight_dir,
                         f"sim_flight_{scenario_name}_{node.name}.jsonl"),
            reason=f"sim:{scenario_name}")


def _convergence_gate(spec, anchor_state, anchor_block,
                      sim_nodes: List[SimNode], script: _Script,
                      clients: List[LightClientNode] = ()) -> None:
    """The differential claim, in five layers (any failure raises with
    the cross-node diff): identical block sets, identical latest-message
    tables, identical heads, that head equal to ``spec.get_head``
    recomputed on each node's own store AND on a from-scratch union
    store, and every light client's proof-backed head equal to it with
    zero proof-verification failures."""
    # 1. every honest node knows the same blocks
    sets = [frozenset(bytes(r) for r in n.head.store.blocks)
            for n in sim_nodes]
    for node, got in zip(sim_nodes[1:], sets[1:]):
        if got != sets[0]:
            missing = {r.hex()[:12] for r in (sets[0] - got)}
            extra = {r.hex()[:12] for r in (got - sets[0])}
            raise SimDivergence(
                f"block-set divergence at {node.name}: missing={missing} "
                f"extra={extra}")

    # 2. identical latest-message tables (one vote per validator/epoch by
    # construction, so any mismatch is a delivery-dependence bug)
    tables = [
        {int(i): (int(m.epoch), bytes(m.root))
         for i, m in n.head.store.latest_messages.items()}
        for n in sim_nodes
    ]
    for node, table in zip(sim_nodes[1:], tables[1:]):
        if table != tables[0]:
            diff = {
                i for i in set(tables[0]) | set(table)
                if tables[0].get(i) != table.get(i)
            }
            raise SimDivergence(
                f"latest-message divergence at {node.name}: validators "
                f"{sorted(diff)[:8]}{'...' if len(diff) > 8 else ''}")

    # 3. one head everywhere
    heads = [n.get_head() for n in sim_nodes]
    if len(set(heads)) != 1:
        raise SimDivergence(
            "head divergence: "
            + ", ".join(f"{n.name}={h.hex()[:12]}"
                        for n, h in zip(sim_nodes, heads)))

    # 4. the head is the spec's head — per node store and on the union
    for node in sim_nodes:
        spec_head = bytes(spec.get_head(node.head.store))
        if spec_head != heads[0]:
            raise SimDivergence(
                f"proto-array diverged from spec.get_head on {node.name}'s "
                f"store: proto={heads[0].hex()[:12]} "
                f"spec={spec_head.hex()[:12]}")
    union = spec.get_forkchoice_store(anchor_state, anchor_block)
    union.time = max(n.head.store.time for n in sim_nodes)
    src = sim_nodes[0].head.store
    anchor_root = spec.hash_tree_root(anchor_block)
    shared_state = union.block_states[anchor_root]
    for root in sorted(src.blocks, key=lambda r: (int(src.blocks[r].slot),
                                                  bytes(r))):
        if root != anchor_root:
            union.blocks[root] = src.blocks[root]
            union.block_states[root] = shared_state
    for i, msg in src.latest_messages.items():
        union.latest_messages[i] = msg
    union_head = bytes(spec.get_head(union))
    if union_head != heads[0]:
        raise SimDivergence(
            f"union-view divergence: nodes={heads[0].hex()[:12]} "
            f"spec(union)={union_head.hex()[:12]}")

    # long-range attacks must FAIL: the zero-weight private fork never
    # becomes anyone's head
    if script.private_fork_roots and heads[0] in set(
            script.private_fork_roots):
        raise SimDivergence(
            "long-range attack succeeded: the agreed head is on the "
            "adversary's private fork")

    # 5. the proof plane: every light client verified served proofs
    # (zero cryptographic rejections) and its proof-backed head is THE
    # head — proof correctness is convergence-gated, not best-effort
    for client in clients:
        if client.failures:
            raise SimDivergence(
                f"light client {client.name} rejected {client.failures} "
                f"served proof(s) as cryptographically invalid")
        if not client.verified:
            raise SimDivergence(
                f"light client {client.name} never verified a proof "
                f"({client.fetches} fetches)")
        if bytes(client.head_root) != heads[0]:
            raise SimDivergence(
                f"light-client head divergence at {client.name}: "
                f"proof-backed head {client.head_root.hex()[:12]} != "
                f"{heads[0].hex()[:12]}")
