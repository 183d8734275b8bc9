"""The adversary: crafted hostile traffic for the scenario runs (the
port's copy of consensus_specs_tpu/sim/adversary.py).

Pure builders — no fabric or node state. The runner decides WHEN and TO
WHOM adversarial messages are published; this module only constructs the
payloads (and keeps their bookkeeping honest, so the convergence gate
can exclude what never legitimately entered the honest view):

- **equivocating proposals**: two conflicting blocks at the same slot
  with the same parent (distinct state roots), the classic slashable
  double proposal — published to opposite halves of the network;
- **private long-range fork**: a parent-linked chain grown from the
  anchor in secret and released at the end of the run (zero attestation
  weight: LMD-GHOST must shrug it off on every node);
- **withheld proposals**: leaf blocks whose committees vote for them
  before any node has the block — released slots later to a single node
  and gossiped outward (network-wide deferred-then-resolved);
- **censored aggregates**: committee aggregates the adversarial
  aggregator never publishes at all.
"""
import random
from typing import List, Tuple

__all__ = [
    "equivocating_twin", "private_fork", "withheld_sibling",
]


def _craft_block(spec, slot: int, parent_root, rng: random.Random):
    return spec.BeaconBlock(
        slot=slot,
        proposer_index=0,
        parent_root=parent_root,
        state_root=rng.getrandbits(256).to_bytes(32, "little"),
    )


def equivocating_twin(spec, block, rng: random.Random):
    """A conflicting proposal at ``block``'s slot and parent — the other
    half of a slashable double proposal. Distinct by state root, so the
    pair shares (slot, parent) but never a tree position."""
    twin = _craft_block(spec, int(block.slot), block.parent_root, rng)
    assert spec.hash_tree_root(twin) != spec.hash_tree_root(block)
    return twin


def withheld_sibling(spec, parent_root, slot: int, rng: random.Random):
    """A fresh LEAF proposal at ``slot`` the adversary will withhold.
    Built as a new sibling (never an interior block) so withholding it
    can orphan only its own votes, not honest descendants."""
    return _craft_block(spec, slot, parent_root, rng)


def private_fork(spec, anchor_root, anchor_slot: int, length: int,
                 rng: random.Random) -> List[Tuple[bytes, object]]:
    """A parent-linked private chain of ``length`` blocks from the anchor
    (slots anchor_slot+1..anchor_slot+length), returned tip-last as
    ``(root, block)`` pairs in release order (parents first — a receiver
    imports them in-order off one gossip burst)."""
    out = []
    parent = anchor_root
    for i in range(length):
        block = _craft_block(spec, anchor_slot + 1 + i, parent, rng)
        root = spec.hash_tree_root(block)
        out.append((bytes(root), block))
        parent = root
    return out
