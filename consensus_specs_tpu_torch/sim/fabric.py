"""Deterministic discrete-event gossip fabric for the simnet plane (the
port's copy of consensus_specs_tpu/sim/fabric.py).

The fabric models the network between N simulated nodes — and nothing
else: WHAT flows (blocks, attestation aggregates) and WHAT the endpoints
do with it live in ``node.py``/``runner.py``. Here:

- **flood gossip**: a publish goes to every peer; a node re-broadcasts a
  message exactly once, on first receipt (dedup rides in the node) — the
  standard epidemic shape, so one lost transmission is usually healed by
  a redundant path;
- **per-link latency**: base + uniform jitter, scaled per-node by the
  scenario's ``latency_skew`` map (a laggard node models the slow-peer
  degradation the Beacon-client security review calls out);
- **loss**: i.i.d. per-transmission drop with probability ``loss_rate``
  (gossip is UDP-flavored; the sync path below is not);
- **partitions**: a group assignment cuts every cross-group link; formed
  and healed on the scenario's schedule. Cross-partition transmissions
  are DROPPED (not parked) — recovery is the sync path's job, exactly
  like real clients re-syncing over req/resp after reconnect;
- **sync**: a reliable (lossless, partition-respecting) re-announcement
  used at heal time and on the scenario's periodic anti-entropy
  schedule — the TCP-flavored req/resp recovery channel.

Everything random draws from the one injected ``random.Random``; event
ordering is a ``(time, seq)`` heap — two runs with the same seed replay
the identical event sequence, which is what the determinism gate hashes.
"""
import heapq
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Event", "EventQueue", "Fabric", "Message", "PartitionWindow",
]


@dataclass(frozen=True)
class PartitionWindow:
    """One scheduled partition: formed at ``form_slot``, healed at
    ``heal_slot`` (simulated slot times), splitting the node indices into
    ``groups`` (every node must appear in exactly one group)."""

    form_slot: float
    heal_slot: float
    groups: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        assert self.heal_slot > self.form_slot, "heal must follow form"
        seen = [i for g in self.groups for i in g]
        assert len(seen) == len(set(seen)), "node in two partition groups"


class Message:
    """One gossip-able unit: a block or an attestation aggregate. The
    ``mid`` is the dedup/journal identity; ``payload`` is the spec object
    (shared read-only across nodes)."""

    __slots__ = ("mid", "kind", "payload")

    def __init__(self, mid: str, kind: str, payload):
        assert kind in ("block", "atts")
        self.mid = mid
        self.kind = kind
        self.payload = payload

    def __repr__(self):
        return f"Message({self.mid})"


@dataclass(order=True)
class Event:
    """Heap entry: ``(time, seq)`` orders the run; ``kind``/``data`` are
    compared never (field(compare=False)) so payloads need no ordering."""

    time: float
    seq: int
    kind: str = field(compare=False)
    data: dict = field(compare=False)


class EventQueue:
    """A (time, seq) min-heap with a monotone sequence — deterministic
    tie-breaking for events scheduled at the same instant."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, **data) -> None:
        self._seq += 1
        heapq.heappush(self._heap, Event(time, self._seq, kind, data))

    def pop(self) -> Optional[Event]:
        return heapq.heappop(self._heap) if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


class Fabric:
    """Link state + transmission bookkeeping between ``n_nodes``."""

    def __init__(self, n_nodes: int, rng: random.Random, *,
                 base_latency: float = 0.05, jitter: float = 0.02,
                 latency_skew: Optional[Dict[int, float]] = None,
                 loss_rate: float = 0.0):
        assert n_nodes >= 2
        self.n_nodes = n_nodes
        self._rng = rng
        self._base = base_latency
        self._jitter = jitter
        self._skew = dict(latency_skew or {})
        self._loss = loss_rate
        self._group_of: Optional[Dict[int, int]] = None  # None: connected
        # the observability counters the scenario report carries
        self.transmissions = 0
        self.deliveries = 0
        self.loss_drops = 0
        self.partition_drops = 0
        self.sync_sends = 0

    # -- topology ------------------------------------------------------------

    @property
    def partitioned(self) -> bool:
        return self._group_of is not None

    def set_partition(self, groups: Tuple[Tuple[int, ...], ...]) -> None:
        group_of = {}
        for gid, members in enumerate(groups):
            for node in members:
                group_of[node] = gid
        # nodes not named in any group get their own island
        for node in range(self.n_nodes):
            group_of.setdefault(node, len(groups) + node)
        self._group_of = group_of

    def heal(self) -> None:
        self._group_of = None

    def reachable(self, src: int, dst: int) -> bool:
        if self._group_of is None:
            return True
        return self._group_of[src] == self._group_of[dst]

    # -- link draws ----------------------------------------------------------

    def latency(self, src: int, dst: int) -> float:
        skew = max(self._skew.get(src, 1.0), self._skew.get(dst, 1.0))
        return (self._base + self._rng.uniform(0.0, self._jitter)) * skew

    def lost(self) -> bool:
        return self._loss > 0.0 and self._rng.random() < self._loss

    # -- transmission --------------------------------------------------------

    def transmit(self, queue: EventQueue, t: float, src: int, dst: int,
                 msg: Message, *, reliable: bool = False) -> bool:
        """Schedule one src->dst delivery. ``reliable`` is the sync path:
        loss-exempt but still partition-respecting. Returns whether the
        delivery was scheduled (False: dropped, counted)."""
        self.transmissions += 1
        if not self.reachable(src, dst):
            self.partition_drops += 1
            return False
        if not reliable and self.lost():
            self.loss_drops += 1
            return False
        if reliable:
            self.sync_sends += 1
        queue.push(t + self.latency(src, dst), "deliver",
                   dst=dst, src=src, msg=msg, reliable=reliable)
        return True

    def broadcast(self, queue: EventQueue, t: float, src: int,
                  msg: Message, *, reliable: bool = False) -> None:
        """Flood to every peer of ``src`` (the gossip fan-out step)."""
        for dst in range(self.n_nodes):
            if dst != src:
                self.transmit(queue, t, src, dst, msg, reliable=reliable)
