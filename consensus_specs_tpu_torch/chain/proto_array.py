"""The port's copy of consensus_specs_tpu/chain/proto_array.py.

Incremental proto-array LMD-GHOST: the chain plane's head index.

The spec's ``get_head`` (specsrc/phase0/fork_choice.py) recomputes the
whole fork choice on every call — ``filter_block_tree`` walks the block
tree re-deriving leaf viability, and every step of the greedy descent
re-sums ``get_latest_attesting_balance`` over all validators: O(blocks ×
validators) per query. Correct as a spec, useless as a serving path. This
module keeps the same answer *incrementally*, the proto-array shape
production clients use:

- nodes live in one flat list in **insertion order**, which is a
  topological order (a block's parent is always known before the block —
  ``on_block`` guarantees it), so "children before parents" is simply a
  reverse iteration;
- each latest-message change contributes a **weight delta** (+balance at
  the new vote root, −balance at the old one); deltas accumulate between
  batches and one **reverse sweep** per batch propagates them to every
  ancestor while recomputing best-child/best-descendant pointers;
- ``head()`` is then a single pointer read: the justified node's
  best-descendant.

Exactness over speed tricks: the spec filters the tree by **leaf**
viability (``filter_block_tree`` checks the leaf state's
justified/finalized checkpoints and includes an interior node iff any
descendant leaf agrees with the store) — NOT by per-node viability as
some production proto-arrays do. The sweep therefore computes
``subtree_viable`` bottom-up from actual leaves, and the differential
gate (tests/test_chain.py) holds the result bit-identical to
``spec.get_head`` after every mutation batch.

This layer is spec-agnostic on purpose: roots are ``bytes``, checkpoints
are ``(epoch, root)`` tuples, balances are plain ints. The spec-facing
glue (``head_service.py``) normalizes.
"""
from typing import Dict, List, Optional, Tuple

Checkpoint = Tuple[int, bytes]  # (epoch, root); epoch 0 == genesis wildcard

GENESIS_EPOCH = 0


class ProtoNode:
    __slots__ = (
        "root", "parent", "slot",
        "justified_checkpoint", "finalized_checkpoint",
        "weight", "child_count", "best_child", "best_descendant",
        "subtree_viable",
    )

    def __init__(self, root: bytes, parent: Optional[int], slot: int,
                 justified_checkpoint: Checkpoint,
                 finalized_checkpoint: Checkpoint):
        self.root = root
        self.parent = parent  # index into the node list, None for the anchor
        self.slot = slot
        # the block's own post-state checkpoints, frozen at insertion —
        # what the spec's leaf-viability test reads off head_state
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.weight = 0          # subtree LMD weight (after the last sweep)
        self.child_count = 0
        self.best_child = None   # index of the winning viable child
        self.best_descendant = None  # index of the head within this subtree
        self.subtree_viable = False


class ProtoArray:
    """The node store + the one-sweep maintenance pass."""

    def __init__(self):
        self._nodes: List[ProtoNode] = []
        self._index: Dict[bytes, int] = {}
        self._deltas: List[int] = []

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, root: bytes) -> bool:
        return root in self._index

    def node(self, root: bytes) -> ProtoNode:
        return self._nodes[self._index[root]]

    def head(self, justified_root: bytes) -> bytes:
        """O(1): the justified node's best-descendant pointer (itself when
        no viable subtree exists — the spec walk then also stops at the
        justified root immediately)."""
        node = self._nodes[self._index[justified_root]]
        if node.best_descendant is None:
            return node.root
        return self._nodes[node.best_descendant].root

    def reorg_depth(self, old_head: bytes, new_head: bytes) -> int:
        """Slots rolled back by a head move: old head's slot minus the
        common ancestor's. 0 for plain extensions (old head is an
        ancestor of the new one) and for heads no longer tracked."""
        ia = self._index.get(old_head)
        ib = self._index.get(new_head)
        if ia is None or ib is None:
            return 0
        old_slot = self._nodes[ia].slot
        # insertion order is topological: an ancestor always has the
        # smaller index, so walking the larger index up converges on the
        # common ancestor
        while ia != ib:
            if ia > ib:
                ia = self._nodes[ia].parent
            else:
                ib = self._nodes[ib].parent
            if ia is None or ib is None:
                return 0
        return max(0, old_slot - self._nodes[ia].slot)

    def ancestor_at_or_below(self, root: bytes, slot: int) -> Optional[bytes]:
        """First ancestor (or self) with node.slot <= slot — the spec's
        ``get_ancestor`` skip-slot rule, answered from the array."""
        i = self._index.get(root)
        while i is not None:
            n = self._nodes[i]
            if n.slot <= slot:
                return n.root
            i = n.parent
        return None

    # -- mutation ------------------------------------------------------------

    def insert(self, root: bytes, parent_root: Optional[bytes], slot: int,
               justified_checkpoint: Checkpoint,
               finalized_checkpoint: Checkpoint) -> None:
        """Add one block. The parent must already be present (matching the
        on_block contract), except for the anchor. Duplicate inserts are
        no-ops (gossip re-delivers blocks)."""
        if root in self._index:
            return
        parent = None
        if parent_root is not None and parent_root in self._index:
            parent = self._index[parent_root]
            self._nodes[parent].child_count += 1
        elif self._nodes:
            raise KeyError(f"unknown parent {parent_root!r} for {root!r}")
        self._index[root] = len(self._nodes)
        self._nodes.append(ProtoNode(root, parent, int(slot),
                                     justified_checkpoint,
                                     finalized_checkpoint))
        self._deltas.append(0)

    def add_delta(self, root: bytes, amount: int) -> None:
        """Queue a weight change at ``root`` for the next sweep. Unknown
        roots swallow silently: a vote whose block was pruned can no
        longer influence any tracked subtree."""
        i = self._index.get(root)
        if i is not None:
            self._deltas[i] += amount

    def apply(self, justified: Checkpoint, finalized: Checkpoint) -> None:
        """The one reverse sweep: children are visited before parents, so a
        single pass propagates queued weight deltas upward, derives leaf →
        subtree viability, and rebuilds every best-child/best-descendant
        pointer against the CURRENT store checkpoints."""
        nodes, deltas = self._nodes, self._deltas
        j_epoch, j_root = justified
        f_epoch, f_root = finalized
        # per-sweep scratch: best (weight, root, index) among viable
        # children seen so far, and whether any viable leaf surfaced
        best: List[Optional[Tuple[int, bytes, int]]] = [None] * len(nodes)
        any_viable = [False] * len(nodes)
        for i in range(len(nodes) - 1, -1, -1):
            n = nodes[i]
            if deltas[i]:
                n.weight += deltas[i]
                if n.parent is not None:
                    deltas[n.parent] += deltas[i]
                deltas[i] = 0
            if n.child_count == 0:
                # a LEAF of the full tree: the spec's filter checks the
                # leaf state's checkpoints (epoch 0 acts as a wildcard)
                viable = (
                    (j_epoch == GENESIS_EPOCH
                     or n.justified_checkpoint == (j_epoch, j_root))
                    and (f_epoch == GENESIS_EPOCH
                         or n.finalized_checkpoint == (f_epoch, f_root))
                )
            else:
                viable = any_viable[i]
            n.subtree_viable = viable
            b = best[i]
            if b is None:
                n.best_child = None
                n.best_descendant = None
            else:
                n.best_child = b[2]
                n.best_descendant = nodes[b[2]].best_descendant
                if n.best_descendant is None:
                    n.best_descendant = b[2]
            if n.parent is not None and viable:
                any_viable[n.parent] = True
                pb = best[n.parent]
                # the spec's max(children, key=(weight, root)) tie-break
                if pb is None or (n.weight, n.root) > (pb[0], pb[1]):
                    best[n.parent] = (n.weight, n.root, i)

    def prune(self, finalized_root: bytes) -> int:
        """Drop everything outside the finalized subtree (the spec walk can
        never reach it again: the justified root always descends from the
        finalized root). Returns how many nodes were dropped. Insertion
        (= topological) order is preserved by the rebuild."""
        if finalized_root not in self._index:
            return 0
        keep = [False] * len(self._nodes)
        fin = self._index[finalized_root]
        keep[fin] = True
        for i, n in enumerate(self._nodes):
            if i != fin and n.parent is not None and keep[n.parent]:
                keep[i] = True
        dropped = keep.count(False)
        if dropped == 0:
            return 0
        remap: Dict[int, int] = {}
        nodes: List[ProtoNode] = []
        deltas: List[int] = []
        index: Dict[bytes, int] = {}
        for i, n in enumerate(self._nodes):
            if not keep[i]:
                continue
            remap[i] = len(nodes)
            n.parent = remap.get(n.parent) if n.parent is not None else None
            # pointer fields are rebuilt by the next sweep; clear rather
            # than remap so a pruned best-descendant can never dangle
            n.best_child = None
            n.best_descendant = None
            index[n.root] = len(nodes)
            nodes.append(n)
            deltas.append(self._deltas[i])
        nodes[remap[fin]].parent = None
        self._nodes, self._deltas, self._index = nodes, deltas, index
        return dropped


class ProtoForkChoice:
    """Vote/balance bookkeeping over a :class:`ProtoArray`.

    Owns the latest-message table (validator → (block root, target
    epoch)), the balance set of the justified checkpoint state, and the
    store's current justified/finalized checkpoints. Every mutation
    queues deltas; ``apply()`` runs the single sweep; ``head()`` reads
    the pointer.
    """

    def __init__(self):
        self.array = ProtoArray()
        self._votes: Dict[int, Tuple[bytes, int]] = {}
        self._balances: Dict[int, int] = {}
        self._justified: Checkpoint = (GENESIS_EPOCH, b"")
        self._finalized: Checkpoint = (GENESIS_EPOCH, b"")
        self._justified_root: Optional[bytes] = None

    # -- mutation ------------------------------------------------------------

    def on_block(self, root: bytes, parent_root: Optional[bytes], slot: int,
                 justified_checkpoint: Checkpoint,
                 finalized_checkpoint: Checkpoint) -> None:
        self.array.insert(root, parent_root, slot, justified_checkpoint,
                          finalized_checkpoint)

    def on_latest_message(self, validator: int, root: bytes,
                          epoch: int) -> bool:
        """The spec's latest-message rule: only a strictly newer target
        epoch displaces an existing vote. Returns whether it applied."""
        applied, _token = self.speculate_latest_message(validator, root,
                                                        epoch)
        return applied

    def speculate_latest_message(self, validator: int, root: bytes,
                                 epoch: int):
        """``on_latest_message`` that also returns an undo token — the
        speculative-apply primitive: HeadService applies a
        batch's votes BEFORE the signature verdicts return and, on any
        failure, hands the batch's tokens back to
        :meth:`rollback_latest_messages`. The token captures the
        displaced vote (or None), which with the current balance set is
        everything reversal needs. Returns ``(applied, token)``; a vote
        the latest-message rule rejects applies nothing and yields no
        token."""
        prev = self._votes.get(validator)
        if prev is not None and epoch <= prev[1]:
            return False, None
        balance = self._balances.get(validator, 0)
        if prev is not None and balance:
            self.array.add_delta(prev[0], -balance)
        if balance:
            self.array.add_delta(root, balance)
        self._votes[validator] = (root, epoch)
        return True, (validator, prev)

    def rollback_latest_messages(self, tokens) -> int:
        """Reverse a speculative batch: LIFO over ``tokens`` (the order
        they were produced in), each reversal queueing the exact opposite
        weight deltas and restoring the displaced vote — so a validator
        speculated twice in one batch unwinds through its intermediate
        state back to the pre-batch table, bit-identically. Only valid
        while the balance set is unchanged since the speculation (the
        HeadService batch pipeline guarantees it: checkpoint refreshes
        happen between batches, never inside one). Returns the number of
        reversed applications."""
        reversed_n = 0
        for token in reversed([t for t in tokens if t is not None]):
            validator, prev = token
            cur = self._votes.get(validator)
            balance = self._balances.get(validator, 0)
            if balance and cur is not None:
                self.array.add_delta(cur[0], -balance)
            if prev is None:
                self._votes.pop(validator, None)
            else:
                if balance:
                    self.array.add_delta(prev[0], balance)
                self._votes[validator] = prev
            reversed_n += 1
        return reversed_n

    def update_checkpoints(self, justified: Checkpoint, finalized: Checkpoint,
                           balances: Dict[int, int]) -> int:
        """Track a store checkpoint move. The balance set is the justified
        checkpoint state's active effective balances — when it changes,
        every existing vote is re-based (new − old at its vote root) so
        subtree weights stay exact. Finalization advance prunes; returns
        the pruned node count."""
        pruned = 0
        if balances != self._balances:
            for validator, (root, _epoch) in self._votes.items():
                shift = (balances.get(validator, 0)
                         - self._balances.get(validator, 0))
                if shift:
                    self.array.add_delta(root, shift)
            self._balances = dict(balances)
        if (finalized != self._finalized
                and finalized[0] > self._finalized[0]):
            pruned = self.array.prune(finalized[1])
        self._justified, self._finalized = justified, finalized
        self._justified_root = justified[1]
        return pruned

    def apply(self) -> None:
        """One reverse sweep over the array (call once per batch)."""
        self.array.apply(self._justified, self._finalized)

    # -- reading -------------------------------------------------------------

    def head(self) -> bytes:
        assert self._justified_root is not None, "no checkpoints tracked yet"
        return self.array.head(self._justified_root)

    @property
    def votes(self) -> Dict[int, Tuple[bytes, int]]:
        return self._votes

    @property
    def block_count(self) -> int:
        return len(self.array)
