"""HeadService: gossip in, O(1) ``get_head()`` out (the port's copy of
consensus_specs_tpu/chain/head_service.py; it takes any built spec, the
port's own or the JAX package's, and a port ``VerificationService``, which
runs on the CUDA card unless its caller asks for ``device="cpu"``).

This is the subsystem the serve plane was missing a consumer for: the
streaming verifier (``serve/service.py``) can sustain gossip-rate
signature checks, but verified attestations went nowhere. HeadService
closes the loop:

  on_block / on_attestations (gossip) ──> structural validation against
  the spec Store ──> signature checks routed through a
  ``VerificationService`` (micro-batched, deduped, RLC-combined) ──>
  verified latest-message updates applied to BOTH the spec ``Store``
  (the oracle) and the incremental proto-array (the production path)
  ──> one reverse sweep per batch ──> ``get_head()`` reads a pointer.

The spec ``Store`` is not a shadow — it IS the state source: blocks run
the real ``spec.on_block`` (state transition, checkpoint promotion),
attestations run the real validation pipeline with exactly one
substitution: ``is_valid_indexed_attestation``'s BLS check goes through
the verification service instead of inline crypto. The proto-array is a
derived index over that store, which is what makes the differential gate
meaningful: ``spec.get_head(store)`` recomputed from scratch must equal
the maintained pointer after every mutation batch
(``differential=True`` / ``CONSENSUS_SPECS_TPU_CHAIN_DIFF=1`` asserts it
inline; tests/test_torch_chain.py gates it).

Gossip reality is handled the way real clients do:
- attestations for **unknown blocks** or **future slots/epochs** are
  parked in a bounded deferral buffer keyed by the MISSING DEPENDENCY
  and retried when that dependency can resolve: a block arrival retries
  only the entries whose missing root is now known, a clock tick retries
  everything (time is a trigger for every defer reason). Unrelated block
  arrivals never consume an entry's retry budget — under simulated
  reordering (sim/), an attestation heard before its target block must
  survive arbitrarily many interleaved third-party blocks and still
  apply when its own block finally lands, whatever the delivery order
  ("delay consideration", fork-choice.md);
- attestations with **invalid signatures**, inconsistent FFG/LMD votes,
  or malformed committees are dropped and counted;
- everything observable exports through ``chain.*`` metrics
  (obs/registry.py) and per-batch spans (validate / sig_wait / apply /
  sweep / head) on the request tracer when tracing is enabled; gossip
  items arriving with a birth record (``obs/latency.py``) additionally
  land their end-to-end gossip→head latency in the
  ``latency.gossip_to_head`` histogram at the head stage.

Threading contract: one mutator at a time (a gossip loop), matching the
spec Store's own single-writer shape. Reads (``get_head``,
``head_slot``) are plain attribute loads.
"""
import os
import time
from collections import deque
from typing import List, Optional, Tuple

from ..obs import flight, latency, tracing
from .metrics import ChainMetrics
from .proto_array import ProtoForkChoice

DIFF_ENV = "CONSENSUS_SPECS_TPU_CHAIN_DIFF"
# speculative head application: apply a batch's latest-message
# updates to the proto-array BEFORE the signature verdicts return, and
# roll back (exact weight-delta reversal) if any verdict fails — the head
# answers with the new votes a whole sig_wait earlier, and the RLC
# bisection already localizes any liar the rollback then unwinds
SPECULATE_ENV = "CONSENSUS_SPECS_TPU_SPECULATE"

# attestation routing verdicts (metrics buckets + deferral control)
OK, DEFER, DROP = "ok", "defer", "drop"


def _cp(checkpoint) -> Tuple[int, bytes]:
    return (int(checkpoint.epoch), bytes(checkpoint.root))


class _Verdict:
    """Future-shaped immediate result (the no-service verification path)."""

    __slots__ = ("_value",)

    def __init__(self, value: bool):
        self._value = value

    def result(self, timeout=None) -> bool:
        return self._value


class _Prepared:
    __slots__ = ("attestation", "indices", "future", "birth")

    def __init__(self, attestation, indices, future, birth=None):
        self.attestation = attestation
        self.indices = indices
        self.future = future
        # obs.latency.Birth from gossip ingress (or None): the end-to-end
        # gossip→head timeline's origin and Chrome flow id
        self.birth = birth


class HeadService:
    """Incremental fork choice behind the streaming verifier.

    ``spec`` is a built spec module; ``anchor_state``/``anchor_block``
    boot the store exactly like ``spec.get_forkchoice_store``. ``service``
    is a ``serve.VerificationService`` (or None: signatures verify
    through the spec's own BLS switchboard, honoring ``bls_active``).
    """

    def __init__(self, spec, anchor_state, anchor_block, *, service=None,
                 metrics: Optional[ChainMetrics] = None, tracer=None,
                 differential: Optional[bool] = None,
                 max_deferred: int = 4096, defer_retries: int = 8,
                 verify_timeout: float = 120.0, node: Optional[str] = None,
                 recorder=None, speculative: Optional[bool] = None):
        self.spec = spec
        self.node = node
        self.store = spec.get_forkchoice_store(anchor_state, anchor_block)
        self._service = service
        # `node` labels the whole metric family (chain[<node>].<name>) so
        # N instances — one per simnet node — coexist in one process
        self.metrics = metrics or ChainMetrics(node=node)
        self._tracer = tracer if tracer is not None else tracing.maybe_tracer()
        # flight recorder (obs/flight.py): chain-plane forensics — block
        # arrivals, deferrals, drops, prunes. An explicit per-instance
        # recorder wins (simnet hands each node its own journal);
        # otherwise the env-gated global one. None when disabled; every
        # site guards on `is not None` (the tracer's zero-cost contract)
        self._flight = recorder if recorder is not None \
            else flight.maybe_recorder()
        if differential is None:
            differential = os.environ.get(DIFF_ENV, "0") not in ("", "0")
        self._differential = differential
        if speculative is None:
            speculative = os.environ.get(SPECULATE_ENV, "0") not in ("", "0")
        # speculation needs an async verdict source to hide latency
        # behind; with the inline _Verdict path the verdicts are already
        # in hand before any apply could speculate
        self._speculative = bool(speculative) and service is not None
        self._max_deferred = max_deferred
        self._defer_retries = defer_retries
        self._verify_timeout = verify_timeout
        # (attestation, attempts, missing, birth) — `missing` is the
        # block root the entry is waiting on, or None for time-gated
        # defers (future slot/epoch); `birth` is the item's gossip-ingress
        # record (obs/latency.py) so a deferred-then-resolved attestation
        # still reports its TRUE gossip→head latency, deferral included.
        # Attempts only tick when the entry's own trigger fired and it
        # STILL re-deferred, never on unrelated arrivals.
        self._deferred: "deque[Tuple[object, int, object, object]]" = deque()

        self.fc = ProtoForkChoice()
        anchor_root = bytes(spec.hash_tree_root(anchor_block))
        anchor_state_stored = self.store.block_states[
            spec.hash_tree_root(anchor_block)
        ]
        self.fc.on_block(
            anchor_root, None, int(anchor_block.slot),
            _cp(anchor_state_stored.current_justified_checkpoint),
            _cp(anchor_state_stored.finalized_checkpoint),
        )
        self._cp_key = None
        self._refresh_checkpoints()
        self.fc.apply()
        self._head = self.fc.head()
        self._head_slot = int(anchor_block.slot)
        self.metrics.note_head(int(anchor_block.slot), changed=False,
                               reorg_depth=0)
        self.metrics.export_gauges(tracked_blocks=self.fc.block_count)

    # -- reading -------------------------------------------------------------

    def get_head(self):
        """The maintained head root, O(1). Bit-identical to
        ``spec.get_head(store)`` — the differential gate's claim."""
        return self.spec.Root(self._head)

    @property
    def head_slot(self) -> int:
        # cached next to the head pointer (NOT derived through the array:
        # between a pruning refresh and the batch's head update the old
        # head may be untracked, and readers must stay plain loads)
        return self._head_slot

    @property
    def deferred_count(self) -> int:
        return len(self._deferred)

    # -- gossip ingress ------------------------------------------------------

    def on_tick(self, time_: int) -> None:
        """Clock advance; may promote the justified checkpoint (epoch
        boundary) and unlock deferred future-slot attestations."""
        before = self.spec.get_current_slot(self.store)
        self.spec.on_tick(self.store, self.spec.uint64(int(time_)))
        slot_advanced = self.spec.get_current_slot(self.store) != before
        checkpoint_moved = self._refresh_checkpoints()
        retry = []
        if slot_advanced and self._deferred:
            # time moved: every defer reason is re-examinable (future
            # slots unlock, stale epochs become droppable). Only
            # TIME-gated entries are charged a retry attempt — a
            # block-gated entry's trigger is its missing root, so ticks
            # re-route it uncharged (stale-epoch eviction still applies)
            retry = [(att, attempts, missing is None, birth)
                     for att, attempts, missing, birth in self._deferred]
            self._deferred.clear()
        if retry or checkpoint_moved:
            self._ingest_batch([], retries=retry)

    def _take_resolved_deferred(self) -> list:
        """Deferred entries whose missing dependency is now in the store
        — the ONLY entries a block arrival may retry (charged: their
        trigger fired). Entries waiting on a still-unknown root (or on
        the clock) stay parked with their retry budget untouched, which
        is what makes the buffer's outcome independent of the order
        unrelated blocks arrive in."""
        if not self._deferred:
            return []
        resolved, keep = [], deque()
        for att, attempts, missing, birth in self._deferred:
            if missing is not None and missing in self.store.blocks:
                resolved.append((att, attempts, True, birth))
            else:
                keep.append((att, attempts, missing, birth))
        self._deferred = keep
        return resolved

    def on_block(self, signed_block, process_attestations: bool = True) -> None:
        """Full spec ``on_block`` (state transition included), then the
        proto-array insert and one batch apply covering the block body's
        attestations plus any deferred gossip the new block resolves.
        Invalid blocks raise exactly as the spec does — and leave both
        the store and the array untouched."""
        spec, store = self.spec, self.store
        spec.on_block(store, signed_block)  # raises on invalid
        block = signed_block.message
        root = spec.hash_tree_root(block)
        state = store.block_states[root]
        self.fc.on_block(
            bytes(root), bytes(block.parent_root), int(block.slot),
            _cp(state.current_justified_checkpoint),
            _cp(state.finalized_checkpoint),
        )
        self.metrics.note_block()
        if self._flight is not None:
            self._flight.note("chain", "on_block", slot=int(block.slot),
                              root=bytes(root).hex()[:16],
                              deferred_pending=len(self._deferred))
        self._refresh_checkpoints()
        batch = list(block.body.attestations) if process_attestations else []
        self._ingest_batch(batch, retries=self._take_resolved_deferred())

    def on_attestation(self, attestation, birth=None) -> dict:
        return self.on_attestations([attestation],
                                    births=None if birth is None
                                    else [birth])

    def on_attestations(self, attestations, births=None) -> dict:
        """One gossip micro-batch: validate → verify (batched through the
        service) → apply → one sweep. Returns the routing summary.

        ``births`` (optional, aligned with ``attestations``; entries may
        be None) carries each item's gossip-ingress record
        (``obs/latency.birth()``): the end-to-end gossip→head latency is
        then recorded per item at the head update that reflects its vote,
        and the serve/chain span trees link by Chrome flow id."""
        return self._ingest_batch(list(attestations), births=births)

    # -- pipeline ------------------------------------------------------------

    def _classify(self, attestation) -> Tuple[str, object]:
        """The spec's ``validate_on_attestation`` checks, split into
        "apply now" / "delay consideration" (the spec's own wording for
        unknown blocks and future slots/epochs) / "never valid". Returns
        ``(verdict, missing)``: for DEFER, ``missing`` is the unknown
        block root the entry waits on, or None when only the clock gates
        it — the key the deferral buffer retries on."""
        spec, store = self.spec, self.store
        data = attestation.data
        target = data.target
        current_epoch = spec.compute_epoch_at_slot(spec.get_current_slot(store))
        previous_epoch = (current_epoch - 1 if current_epoch > spec.GENESIS_EPOCH
                          else spec.GENESIS_EPOCH)
        if target.epoch not in (current_epoch, previous_epoch):
            return (DEFER, None) if target.epoch > current_epoch \
                else (DROP, None)
        if target.epoch != spec.compute_epoch_at_slot(data.slot):
            return DROP, None
        if target.root not in store.blocks:
            return DEFER, target.root
        if data.beacon_block_root not in store.blocks:
            return DEFER, data.beacon_block_root
        if store.blocks[data.beacon_block_root].slot > data.slot:
            return DROP, None
        target_slot = spec.compute_start_slot_at_epoch(target.epoch)
        if target.root != spec.get_ancestor(store, data.beacon_block_root,
                                            target_slot):
            return DROP, None
        if spec.get_current_slot(store) < data.slot + 1:
            return DEFER, None
        return OK, None

    def _prepare(self, attestation, birth=None) -> Optional[_Prepared]:
        """Index the attestation against its target checkpoint state and
        submit the signature check. Returns None for structurally invalid
        committees (the spec's non-crypto ``is_valid_indexed_attestation``
        half)."""
        spec, store = self.spec, self.store
        target = attestation.data.target
        try:
            spec.store_target_checkpoint_state(store, target)
            target_state = store.checkpoint_states[target]
            indexed = spec.get_indexed_attestation(target_state, attestation)
        except Exception:
            return None  # malformed committee coordinates
        indices = list(indexed.attesting_indices)
        if not indices or indices != sorted(set(indices)):
            return None
        pubkeys = [target_state.validators[i].pubkey for i in indices]
        domain = spec.get_domain(target_state, spec.DOMAIN_BEACON_ATTESTER,
                                 target.epoch)
        signing_root = bytes(spec.compute_signing_root(indexed.data, domain))
        signature = bytes(attestation.signature)
        if self._service is not None:
            if birth is not None:
                # thread the ingress record through the serve plane: the
                # request trace gains the ingress span and the Chrome
                # flow id that links it to this chain batch
                future = self._service.submit(
                    "fast_aggregate", pubkeys, signing_root, signature,
                    birth_s=birth.t, flow_id=birth.trace_id)
            else:
                future = self._service.submit("fast_aggregate", pubkeys,
                                              signing_root, signature)
        else:
            future = _Verdict(bool(spec.bls.FastAggregateVerify(
                pubkeys, signing_root, signature)))
        return _Prepared(attestation, indices, future, birth=birth)

    def _speculate_item(self, item: _Prepared) -> Tuple[list, int]:
        """Apply one prepared item's latest messages to the PROTO ARRAY
        only, capturing undo tokens (the spec store — the oracle — is
        never speculated on). Returns ``(tokens, moved)``."""
        att = item.attestation
        target_epoch = int(att.data.target.epoch)
        root = bytes(att.data.beacon_block_root)
        tokens, moved = [], 0
        for i in item.indices:
            applied, token = self.fc.speculate_latest_message(
                int(i), root, target_epoch)
            if applied:
                moved += 1
                tokens.append(token)
        return tokens, moved

    def _ingest_batch(self, attestations: List, retries: List = (),
                      births: Optional[List] = None) -> dict:
        """The per-batch pipeline shared by every ingress path. ``retries``
        carries ``(attestation, attempts, charge, birth)`` deferral
        entries riding along — ``charge`` says whether this retry counts
        against the entry's budget (its own trigger fired) or is
        incidental (a tick re-examining a block-gated entry for
        staleness). ``births`` aligns with ``attestations`` (entries may
        be None): the gossip-ingress records the end-to-end latency plane
        stitches from.

        With speculation armed (``CONSENSUS_SPECS_TPU_SPECULATE`` /
        ``speculative=``), the batch's latest messages land on the
        proto-array BEFORE the signature verdicts return — ``get_head``
        answers with the new votes a whole sig_wait earlier. Any failed
        verdict rolls the WHOLE speculative batch back (LIFO weight-delta
        reversal, so intra-batch displacement chains unwind exactly) and
        the verified members re-apply on the normal path — the post-batch
        state is bit-identical to never having speculated, which is what
        the differential gates assert."""
        t0 = time.perf_counter()
        trace = None
        if self._tracer is not None:
            trace = self._tracer.begin("chain_apply",
                                       len(attestations) + len(retries), t0)
        summary = {"applied": 0, "stale": 0, "deferred": 0, "dropped": 0,
                   "resolved": 0}
        prepared: List[Tuple[_Prepared, bool]] = []  # (item, was_deferred)

        def route(att, attempts, was_deferred, charge=True, birth=None):
            verdict, missing = self._classify(att)
            if verdict == OK:
                item = self._prepare(att, birth)
                if item is None:
                    summary["dropped"] += 1
                    self.metrics.note_dropped()
                else:
                    prepared.append((item, was_deferred))
            elif verdict == DEFER and attempts < self._defer_retries \
                    and len(self._deferred) < self._max_deferred:
                attempts = attempts + 1 if charge else attempts
                self._deferred.append((att, attempts, missing, birth))
                summary["deferred"] += 1
                self.metrics.note_deferred(len(self._deferred))
                if self._flight is not None:
                    self._flight.note("chain", "defer",
                                      slot=int(att.data.slot),
                                      attempts=attempts,
                                      pending=len(self._deferred))
            else:  # never valid, retries exhausted, or buffer full
                summary["dropped"] += 1
                self.metrics.note_dropped()
                if self._flight is not None:
                    self._flight.note("chain", "drop",
                                      slot=int(att.data.slot),
                                      verdict=verdict)

        if births is None:
            births = [None] * len(attestations)
        elif len(births) != len(attestations):
            # zip would silently drop the tail — a misaligned caller must
            # fail loudly, not diverge from peers that processed the rest
            raise ValueError(
                f"births misaligned: {len(births)} births for "
                f"{len(attestations)} attestations")
        for att, birth in zip(attestations, births):
            route(att, 0, was_deferred=False, birth=birth)
        for att, attempts, charge, birth in retries:
            route(att, attempts, was_deferred=True, charge=charge,
                  birth=birth)
        t1 = time.perf_counter()

        # -- speculative apply (before any verdict is in hand) ---------------
        speculated = False
        spec_tokens: list = []
        spec_moved: dict = {}
        t_spec_head = None
        if self._speculative and prepared:
            for item, _was_deferred in prepared:
                tokens, moved = self._speculate_item(item)
                spec_tokens.extend(tokens)
                spec_moved[id(item)] = moved
            self.fc.apply()
            self._update_head()
            t_spec_head = time.perf_counter()
            speculated = True
            self.metrics.note_speculative(len(prepared))
            if self._flight is not None:
                self._flight.note("chain", "speculative_apply",
                                  items=len(prepared),
                                  votes=len(spec_tokens),
                                  head_slot=self._head_slot)

        # the whole batch's signature checks are in the service's
        # micro-batching pipeline now; collect verdicts
        verified: List[Tuple[_Prepared, bool]] = []
        failed = 0
        for item, was_deferred in prepared:
            try:
                ok = bool(item.future.result(timeout=self._verify_timeout))
            except Exception:
                ok = False  # service backpressure/close counts as a drop
            if ok:
                verified.append((item, was_deferred))
            else:
                failed += 1
                summary["dropped"] += 1
                self.metrics.note_dropped()
                if self._flight is not None:
                    self._flight.note(
                        "chain", "drop",
                        slot=int(item.attestation.data.slot),
                        verdict="bad_signature")
        t2 = time.perf_counter()

        if speculated and failed:
            # a liar in the batch: unwind EVERYTHING this batch put on
            # the array (LIFO, exact), then let the verified members
            # re-apply below exactly as an unspeculated batch would —
            # never surgically keep speculative state around a failure
            reverted = self.fc.rollback_latest_messages(spec_tokens)
            self.metrics.note_rollback()
            if self._flight is not None:
                self._flight.note("chain", "rollback", failed=failed,
                                  reverted=reverted, items=len(prepared))
            speculated = False
            t_spec_head = None

        for item, was_deferred in verified:
            if speculated:
                # proto array already holds this item's votes; mirror
                # them into the spec store (the oracle is only ever fed
                # VERIFIED votes, speculation or not)
                self.spec.update_latest_messages(
                    self.store, item.indices, item.attestation)
                applied = spec_moved.get(id(item), 0)
            else:
                applied = self._apply_latest_messages(item)
            if applied:
                summary["applied"] += applied
                self.metrics.note_applied(applied)
            else:
                summary["stale"] += 1
                self.metrics.note_stale()
            if was_deferred:
                summary["resolved"] += 1
                self.metrics.note_resolved(len(self._deferred))
        t3 = time.perf_counter()

        self.fc.apply()
        self._update_head()
        t4 = time.perf_counter()

        # -- head stage: the end-to-end timeline terminates here --------------
        # an item's gossip→head latency ends at the head update that
        # first reflected its vote: the SPECULATIVE update when the whole
        # batch survived, the post-verdict sweep otherwise
        head_ts = t_spec_head if t_spec_head is not None else t4
        flows = []
        for item, _was_deferred in verified:
            if item.birth is not None:
                latency.note_gossip_to_head(max(0.0, head_ts - item.birth.t))
                flows.append(item.birth.trace_id)
        t5 = time.perf_counter()

        self.metrics.note_batch(t5 - t0)
        self.metrics.export_gauges(tracked_blocks=self.fc.block_count)
        latency.note_stage("validate", t1 - t0)
        latency.note_stage("sig_wait", t2 - t1)
        latency.note_stage("apply", t3 - t2)
        latency.note_stage("sweep", t4 - t3)
        latency.note_stage("head", t5 - t4)
        if trace is not None:
            self._tracer.span(trace, "validate", t0, t1)
            self._tracer.span(trace, "sig_wait", t1, t2)
            self._tracer.span(trace, "apply", t2, t3)
            self._tracer.span(trace, "sweep", t3, t4)
            self._tracer.span(trace, "head", t4, t5)
            trace.flows = tuple(flows)
            self._tracer.finish(trace, True, t5)
        if self._differential:
            self._assert_spec_head()
        return summary

    def _apply_latest_messages(self, item: _Prepared) -> int:
        """Mirror ``spec.update_latest_messages`` into both tables; returns
        how many validators' latest messages actually moved."""
        att = item.attestation
        target_epoch = int(att.data.target.epoch)
        root = bytes(att.data.beacon_block_root)
        moved = 0
        for i in item.indices:
            if self.fc.on_latest_message(int(i), root, target_epoch):
                moved += 1
        self.spec.update_latest_messages(self.store, item.indices, att)
        return moved

    def _refresh_checkpoints(self) -> bool:
        """Sync the array's viability/balance inputs with the store's
        (possibly just-moved) justified/finalized checkpoints."""
        spec, store = self.spec, self.store
        jc, fin = store.justified_checkpoint, store.finalized_checkpoint
        key = (_cp(jc), _cp(fin))
        if key == self._cp_key:
            return False
        # the balance source the spec's weight sum reads; materialize it
        # if no attestation has targeted this checkpoint yet (the spec's
        # own get_head needs the same entry to exist)
        spec.store_target_checkpoint_state(store, jc)
        state = store.checkpoint_states[jc]
        active = spec.get_active_validator_indices(
            state, spec.get_current_epoch(state))
        balances = {
            int(i): int(state.validators[i].effective_balance) for i in active
        }
        pruned = self.fc.update_checkpoints(_cp(jc), _cp(fin), balances)
        if pruned:
            self.metrics.note_pruned(pruned)
            if self._flight is not None:
                self._flight.note("chain", "prune", nodes=pruned,
                                  finalized_epoch=_cp(fin)[0])
        self._cp_key = key
        return True

    def _update_head(self) -> None:
        new_head = self.fc.head()
        if new_head == self._head:
            self.metrics.note_head(self._head_slot, changed=False,
                                   reorg_depth=0)
            return
        depth = self.fc.array.reorg_depth(self._head, new_head)
        self._head = new_head
        self._head_slot = self.fc.array.node(new_head).slot
        self.metrics.note_head(self._head_slot, changed=True,
                               reorg_depth=depth)

    def _assert_spec_head(self) -> None:
        spec_head = bytes(self.spec.get_head(self.store))
        if spec_head != self._head:
            raise AssertionError(
                "proto-array head diverged from the spec oracle: "
                f"proto={self._head.hex()[:16]} spec={spec_head.hex()[:16]} "
                f"(blocks={self.fc.block_count}, "
                f"justified={self.store.justified_checkpoint.epoch})"
            )

    # -- synthetic replay ----------------------------------------------------

    def import_block_unchecked(self, block, state=None,
                               resolve: bool = False) -> None:
        """Replay/bench ingress: register a block WITHOUT running the state
        transition (the synthetic fork replays in ``bench/head_replay.py``
        build trees whose states are crafted, not computed). Never use on
        a live store — ``on_block`` is the validated path. ``resolve``
        additionally retries the deferred gossip this arrival can resolve
        and sweeps (a block arrival on the validated path always does);
        bulk imports leave it off and call ``resweep()`` once."""
        spec, store = self.spec, self.store
        root = spec.hash_tree_root(block)
        if root in store.blocks:
            return
        store.blocks[root] = block
        if state is not None:
            store.block_states[root] = state
            cps = (_cp(state.current_justified_checkpoint),
                   _cp(state.finalized_checkpoint))
        else:
            cps = (_cp(store.justified_checkpoint),
                   _cp(store.finalized_checkpoint))
        self.fc.on_block(bytes(root), bytes(block.parent_root),
                         int(block.slot), *cps)
        self.metrics.note_block()
        if self._flight is not None:
            self._flight.note("chain", "on_block", slot=int(block.slot),
                              root=bytes(root).hex()[:16],
                              deferred_pending=len(self._deferred))
        if resolve:
            self._ingest_batch([], retries=self._take_resolved_deferred())

    def resweep(self) -> None:
        """Force one sweep + head refresh (after bulk unchecked imports)."""
        self.fc.apply()
        self._update_head()
        self.metrics.export_gauges(tracked_blocks=self.fc.block_count)
