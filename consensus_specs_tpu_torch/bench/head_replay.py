"""Synthetic fork-and-gossip replay: spec-store ``get_head`` vs the
chain plane's proto-array, at growing block-tree sizes. The port's copy of
consensus_specs_tpu/bench/head_replay.py: ``run_head_bench(device=None)``
runs every service on ``device`` (None: the CUDA card); the replay is
crypto-free and launches no kernel.

The spec's ``get_head`` re-derives the whole fork choice per query
(``filter_block_tree`` rescans every block's children, every descent
step re-sums latest-message balances): O(blocks² + blocks × validators)
as written. The chain plane answers the same question from a maintained
pointer. This bench replays ONE identical gossip history against both
and reports heads/sec each, per tree size; the acceptance bar is
proto-array ≥ 10x the spec path at the largest tree (``vs_baseline`` =
speedup/10 at that tree).

The replay (per tree size, epochs phase by phase on a live clock):
- a randomized fork tree over E epochs (branching parents at every slot,
  one shared crafted state — no state transitions: the thing measured is
  fork-choice maintenance, not block processing);
- attestation gossip batches whose committees/targets are real spec
  committees of the crafted state, with fault injection from
  ``serve/load.py``: ``invalid_sig`` events carry ``BAD_SIGNATURE`` (the
  service answers False — must be dropped), ``orphan`` events reference
  an epoch block withheld until mid-phase (must defer, then resolve when
  the block arrives);
- the proto path runs the REAL pipeline: ``HeadService`` +
  ``VerificationService`` over the crypto-free ``VerdictBackend``
  (batching/dedup/False-routing exercised, pairings skipped — verdicts,
  not crypto, are what fork choice consumes);
- the spec path replays the identical applied-vote sequence and calls
  ``spec.get_head`` at up to HEAD_SPEC_QUERIES sample batches (the cap
  is reported — at 1k blocks a single spec query costs ~a second);
- heads are ASSERTED equal at every spec sample point: a replay that
  diverges fails loudly instead of recording a throughput number.

``heads/sec`` is **query serving throughput**: after each applied batch,
how many ``get_head()`` answers per second the store can serve — the
question every proposal/attestation duty asks. The proto path reads the
maintained pointer (HEAD_QUERY_ROUNDS reads per batch, timed); the spec
path pays its full recompute per query. Ingestion is NOT hidden in that
number — it is reported alongside (``gossip_events_per_sec``, the
``chain.apply_batch`` latency reservoir), and the proto path's ingestion
includes the whole service round-trip the spec replay is spared.

Env knobs: HEAD_TREE_SIZES ("64,256,1024"), HEAD_EPOCHS (4),
HEAD_EVENTS_PER_EPOCH (32), HEAD_BATCH (8), HEAD_SEED (7),
HEAD_QUERY_ROUNDS (64), HEAD_INVALID_RATE (0.06), HEAD_ORPHAN_RATE
(0.06), HEAD_SPEC_QUERIES (4); SERVE_METRICS_PORT serves /metrics +
/snapshot during the largest proto replay and the JSON line records the
mid-load ``chain.*`` scrape.
"""
import os
import random
import time
from typing import Dict, List, Optional, Tuple


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


class _Tree:
    """A synthetic fork tree: spec BeaconBlocks over slots 1..8*E with
    randomized parents, plus the per-epoch committee tables of the one
    shared crafted state."""

    def __init__(self, spec, anchor_state, anchor_block, epochs: int,
                 n_blocks: int, rng: random.Random):
        self.spec = spec
        self.epochs = epochs
        self.anchor_root = spec.hash_tree_root(anchor_block)
        self.blocks: Dict = {self.anchor_root: anchor_block}
        self.parent: Dict = {}
        self.slot_of: Dict = {int(anchor_block.slot): [self.anchor_root]}
        self.by_epoch: List[List] = [[] for _ in range(epochs)]
        slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
        # last slot stops one short of the final epoch boundary: phase e
        # runs with the clock at slot 8*(e+1), and every epoch-e
        # attestation (slot <= 8e+7) must already be "in the past"
        total_slots = slots_per_epoch * epochs - 1
        roots_by_slot: Dict[int, List] = {0: [self.anchor_root]}
        ordered_slots = [0]
        for i in range(n_blocks):
            slot = rng.randint(1, total_slots)
            # parent: any block at a strictly earlier slot (genesis always
            # qualifies) — this is what makes the tree a fork tree
            candidates = [s for s in ordered_slots if s < slot]
            parent_slot = rng.choice(candidates)
            parent_root = rng.choice(roots_by_slot[parent_slot])
            block = spec.BeaconBlock(
                slot=slot,
                proposer_index=0,
                parent_root=parent_root,
                state_root=rng.getrandbits(256).to_bytes(32, "little"),
            )
            root = spec.hash_tree_root(block)
            if root in self.blocks:
                continue
            self.blocks[root] = block
            self.parent[root] = parent_root
            if slot not in roots_by_slot:
                roots_by_slot[slot] = []
                ordered_slots.append(slot)
            roots_by_slot[slot].append(root)
            self.by_epoch[slot // slots_per_epoch].append(root)
        self.leaves = (set(self.blocks) - {self.anchor_root}
                       - set(self.parent.values()))

        # committee tables per epoch, from the one crafted state — the
        # same committees `store_target_checkpoint_state` derives
        self.committees: Dict[Tuple[int, int], List[int]] = {}
        self.committee_count: Dict[int, int] = {}
        state = anchor_state.copy()
        for epoch in range(epochs):
            start = spec.compute_start_slot_at_epoch(spec.Epoch(epoch))
            if state.slot < start:
                spec.process_slots(state, start)
            per_slot = int(spec.get_committee_count_per_slot(
                state, spec.Epoch(epoch)))
            for s in range(int(start), int(start) + slots_per_epoch):
                self.committee_count[s] = per_slot
                for idx in range(per_slot):
                    self.committees[(s, idx)] = [
                        int(v) for v in spec.get_beacon_committee(
                            state, spec.Slot(s), spec.CommitteeIndex(idx))
                    ]

    def ancestor_at(self, root, slot: int):
        r = root
        while int(self.blocks[r].slot) > slot:
            r = self.parent[r]
        return r


class _Gossip:
    """One attestation gossip event (spec Attestation + precomputed
    committee indices + its fault tag)."""

    __slots__ = ("attestation", "indices", "fault", "block_root")

    def __init__(self, attestation, indices, fault, block_root):
        self.attestation = attestation
        self.indices = indices
        self.fault = fault
        self.block_root = block_root


def _build_gossip(spec, tree: _Tree, epoch: int, events: int,
                  rng: random.Random, plan: List[str],
                  withheld: set) -> List[_Gossip]:
    """Epoch-``epoch`` gossip: full-committee aggregates over the epoch's
    blocks. ``orphan`` events pick a withheld block when one exists."""
    from ..serve.load import BAD_SIGNATURE

    slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
    target_slot = epoch * slots_per_epoch
    pool = tree.by_epoch[epoch]
    out: List[_Gossip] = []
    if not pool:
        return out
    withheld_pool = [r for r in pool if r in withheld]
    open_pool = [r for r in pool if r not in withheld]
    for e in range(events):
        fault = plan[e]
        if fault == "orphan" and withheld_pool:
            root = rng.choice(withheld_pool)
        elif open_pool:
            root = rng.choice(open_pool)
        else:
            root = rng.choice(pool)
        block = tree.blocks[root]
        slot = int(block.slot)
        idx = rng.randrange(tree.committee_count[slot])
        committee = tree.committees[(slot, idx)]
        target_root = tree.ancestor_at(root, target_slot)
        data = spec.AttestationData(
            slot=slot,
            index=idx,
            beacon_block_root=root,
            source=spec.Checkpoint(),
            target=spec.Checkpoint(epoch=epoch, root=target_root),
        )
        bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](
            [1] * len(committee))
        signature = (BAD_SIGNATURE if fault == "invalid_sig"
                     else (b"\x5e" + bytes(target_root)[:15]
                           + bytes(root)[:16]) * 3)
        att = spec.Attestation(data=data, aggregation_bits=bits,
                               signature=signature)
        out.append(_Gossip(att, list(committee), fault, root))
    return out


def _slot_time(spec, genesis_time: int, slot: int) -> int:
    return int(genesis_time) + slot * int(spec.config.SECONDS_PER_SLOT)


def _proto_replay(spec, anchor_state, anchor_block, tree: _Tree,
                  gossip_by_epoch, withheld_by_epoch, batch: int,
                  query_rounds: int, expose: bool, device):
    """The production path: HeadService + VerificationService over the
    VerdictBackend. Returns (heads per batch index, timing, summary,
    scrape record)."""
    from ..chain import HeadService
    from ..serve.load import VerdictBackend
    from ..serve.service import VerificationService
    from ..utils import bls

    backend = VerdictBackend()
    scrape: Dict[str, object] = {}
    was_active = bls.bls_active
    bls.bls_active = True  # verdicts must flow through the service
    exposition = None
    svc = VerificationService(backend=backend, device=device,
                              max_batch=max(8, batch), max_wait_ms=2.0)
    try:
        head = HeadService(spec, anchor_state, anchor_block, service=svc,
                           differential=False)
        if expose:
            port_env = (os.environ.get("SERVE_METRICS_PORT") or "").strip()
            if port_env:
                from ..obs.exposition import start_exposition

                exposition = start_exposition(
                    snapshot_fn=head.metrics.snapshot, port=int(port_env))
        shared_state = head.store.block_states[tree.anchor_root]
        heads: List[bytes] = []
        queries = 0
        query_s = 0.0
        events = 0
        scrape_thread = None

        def _scrape_midload():
            # on a HELPER thread (serve/load.py pattern): a slow or wedged
            # endpoint must never inflate the timed ingestion window — the
            # scrape still happens while the replay is live
            import urllib.request

            try:
                with urllib.request.urlopen(exposition.url("/metrics"),
                                            timeout=30) as r:
                    body = r.read().decode()
                scrape["lines"] = len(body.splitlines())
                scrape["chain_lines"] = sum(
                    1 for ln in body.splitlines()
                    if ln.startswith("consensus_specs_tpu_chain_"))
            except Exception:
                pass

        t0 = time.perf_counter()
        for epoch, gossip in enumerate(gossip_by_epoch):
            # clock to the first slot PAST the epoch (its attestations all
            # become "slot in the past"), then the epoch's open blocks
            clock_slot = (epoch + 1) * int(spec.SLOTS_PER_EPOCH)
            head.on_tick(_slot_time(spec, anchor_state.genesis_time,
                                    clock_slot))
            withheld = withheld_by_epoch[epoch]
            for root in tree.by_epoch[epoch]:
                if root not in withheld:
                    head.import_block_unchecked(tree.blocks[root],
                                                state=shared_state)
            head.resweep()
            mid = len(gossip) // 2
            for start in range(0, len(gossip), batch):
                if start <= mid < start + batch:
                    # mid-phase: the withheld blocks arrive; deferred
                    # orphan gossip must resolve on the last arrival
                    for i, root in enumerate(sorted(withheld)):
                        head.import_block_unchecked(
                            tree.blocks[root], state=shared_state,
                            resolve=(i == len(withheld) - 1))
                    if not withheld:
                        head.resweep()
                    withheld = set()
                chunk = gossip[start:start + batch]
                head.on_attestations([g.attestation for g in chunk])
                events += len(chunk)
                # the serving measurement: answer get_head against the
                # live store, query_rounds times per applied batch
                tq = time.perf_counter()
                h = None
                for _ in range(query_rounds):
                    h = head.get_head()
                query_s += time.perf_counter() - tq
                queries += query_rounds
                heads.append(bytes(h))
                if exposition is not None and scrape_thread is None:
                    import threading

                    scrape_thread = threading.Thread(
                        target=_scrape_midload, daemon=True)
                    scrape_thread.start()
        elapsed = time.perf_counter() - t0
        if scrape_thread is not None:
            scrape_thread.join(35)
        timing = {
            "queries": queries,
            "query_s": query_s,
            "events": events,
            "wall_s": elapsed,
        }
        return heads, timing, head.metrics.snapshot(), scrape
    finally:
        svc.close(timeout=30)
        if exposition is not None:
            exposition.close()
        bls.bls_active = was_active


def _spec_replay(spec, anchor_state, anchor_block, tree: _Tree,
                 gossip_by_epoch, withheld_by_epoch, batch: int,
                 proto_heads: List[bytes], max_queries: int):
    """The oracle path over the identical history: direct Store
    mutations + ``spec.get_head`` at sampled batch indices, asserted
    against the proto path's head at the same index."""
    store = spec.get_forkchoice_store(anchor_state, anchor_block)
    shared_state = store.block_states[tree.anchor_root]

    # total batch count drives the sample stride
    n_batches = sum(
        (len(g) + batch - 1) // batch for g in gossip_by_epoch if g)
    stride = max(1, n_batches // max(1, max_queries))
    deferred: List[_Gossip] = []
    batch_index = 0
    queries = 0
    query_s = 0.0

    def apply(g: _Gossip):
        att = g.attestation
        spec.update_latest_messages(store, g.indices, att)

    for epoch, gossip in enumerate(gossip_by_epoch):
        store.time = spec.uint64(_slot_time(
            spec, anchor_state.genesis_time,
            (epoch + 1) * int(spec.SLOTS_PER_EPOCH)))
        withheld = set(withheld_by_epoch[epoch])
        for root in tree.by_epoch[epoch]:
            if root not in withheld:
                store.blocks[root] = tree.blocks[root]
                store.block_states[root] = shared_state
        mid = len(gossip) // 2
        for start in range(0, len(gossip), batch):
            if start <= mid < start + batch:
                for root in sorted(withheld):
                    store.blocks[root] = tree.blocks[root]
                    store.block_states[root] = shared_state
                withheld = set()
                still = []
                for g in deferred:
                    if g.block_root in store.blocks:
                        apply(g)
                    else:
                        still.append(g)
                deferred = still
            for g in gossip[start:start + batch]:
                if g.fault == "invalid_sig":
                    continue  # the service answered False; never applied
                if g.block_root not in store.blocks:
                    deferred.append(g)
                else:
                    apply(g)
            if batch_index % stride == 0 and queries < max_queries:
                tq = time.perf_counter()
                got = bytes(spec.get_head(store))
                query_s += time.perf_counter() - tq
                assert got == proto_heads[batch_index], (
                    f"head divergence at batch {batch_index}: "
                    f"spec={got.hex()[:16]} "
                    f"proto={proto_heads[batch_index].hex()[:16]}"
                )
                queries += 1
            batch_index += 1
    return queries, query_s


def run_head_bench(device=None) -> dict:
    """Drive the replay across HEAD_TREE_SIZES with every service on
    ``device`` (None: the CUDA card); returns the JAX bench's result
    dict."""
    from ..builder import build_spec_module
    from ..device import resolve_device
    from ..obs import programs as obs_programs, slo
    from ..ops import profiling
    from ..serve.load import plan_gossip_faults
    from ..test.helpers.genesis import create_genesis_state

    device = resolve_device(device)
    profiling.reset()
    obs_programs.export_gauges()
    slo.reset_global()
    # baseline checkpoint: the final slo section's burn windows measure
    # this run (an empty ring would diff the end state against itself)
    slo.global_tracker().evaluate()

    sizes = [int(s) for s in os.environ.get(
        "HEAD_TREE_SIZES", "64,256,1024").split(",") if s.strip()]
    epochs = _env_int("HEAD_EPOCHS", 4)
    events_per_epoch = _env_int("HEAD_EVENTS_PER_EPOCH", 32)
    batch = _env_int("HEAD_BATCH", 8)
    query_rounds = _env_int("HEAD_QUERY_ROUNDS", 64)
    seed = _env_int("HEAD_SEED", 7)
    invalid_rate = _env_float("HEAD_INVALID_RATE", 0.06)
    orphan_rate = _env_float("HEAD_ORPHAN_RATE", 0.06)
    spec_queries = _env_int("HEAD_SPEC_QUERIES", 4)

    spec = build_spec_module("phase0", "minimal")
    anchor_state = create_genesis_state(
        spec, [spec.MAX_EFFECTIVE_BALANCE] * (int(spec.SLOTS_PER_EPOCH) * 8),
        spec.MAX_EFFECTIVE_BALANCE)
    anchor_block = spec.BeaconBlock(state_root=anchor_state.hash_tree_root())

    trees = []
    per_mode_best: Dict[str, float] = {}
    largest: Optional[dict] = None
    for n_blocks in sizes:
        rng = random.Random(seed + n_blocks)
        tree = _Tree(spec, anchor_state, anchor_block, epochs, n_blocks, rng)
        gossip_by_epoch = []
        withheld_by_epoch = []
        for epoch in range(epochs):
            plan = plan_gossip_faults(rng, events_per_epoch,
                                      invalid_rate, orphan_rate)
            # only LEAF blocks can be withheld: a withheld interior block
            # would orphan its own descendants' imports
            pool = [r for r in tree.by_epoch[epoch] if r in tree.leaves]
            held = set(rng.sample(pool, max(1, len(pool) // 8))) \
                if pool else set()
            withheld_by_epoch.append(held)
            gossip_by_epoch.append(
                _build_gossip(spec, tree, epoch, events_per_epoch, rng,
                              plan, held))
        expose = n_blocks == max(sizes)
        heads, timing, snapshot, scrape = _proto_replay(
            spec, anchor_state, anchor_block, tree, gossip_by_epoch,
            withheld_by_epoch, batch, query_rounds, expose, device)
        s_queries, s_query_s = _spec_replay(
            spec, anchor_state, anchor_block, tree, gossip_by_epoch,
            withheld_by_epoch, batch, heads, spec_queries)
        proto_rate = (timing["queries"] / timing["query_s"]
                      if timing["query_s"] > 0 else 0.0)
        spec_rate = s_queries / s_query_s if s_query_s > 0 else 0.0
        speedup = proto_rate / spec_rate if spec_rate > 0 else 0.0
        entry = {
            "blocks": len(tree.blocks) - 1,
            "proto_heads_per_sec": round(proto_rate, 2),
            "spec_heads_per_sec": round(spec_rate, 4),
            "speedup": round(speedup, 2),
            "proto_queries": timing["queries"],
            # the spec path is SAMPLED (it pays a full recompute per
            # query): the cap is part of the record, never silent
            "spec_queries": s_queries,
            "heads_match": True,  # _spec_replay asserted every sample
            # ingestion is its own number, not hidden in heads/sec: the
            # proto side paid validation + the service round-trip here
            "gossip_events_per_sec": round(
                timing["events"] / timing["wall_s"], 2)
                if timing["wall_s"] > 0 else 0.0,
            "ingest_wall_s": round(timing["wall_s"], 3),
            "applied": snapshot["applied"],
            "deferred": snapshot["deferred"],
            "resolved": snapshot["resolved"],
            "dropped": snapshot["dropped"],
            "head_changes": snapshot["head_changes"],
            "reorgs": snapshot["reorgs"],
        }
        if scrape:
            entry["metrics_scrape_lines"] = scrape.get("lines", 0)
            entry["metrics_chain_lines"] = scrape.get("chain_lines", 0)
        trees.append(entry)
        per_mode_best[f"head[{entry['blocks']}]"] = round(proto_rate, 2)
        if largest is None or entry["blocks"] >= largest["blocks"]:
            largest = entry

    result = dict(
        metric="fork-choice get_head queries/sec (proto-array chain plane)",
        value=largest["proto_heads_per_sec"],
        # the acceptance bar: proto >= 10x the spec path at the largest
        # benched tree — vs_baseline 1.0 == exactly 10x
        vs_baseline=round(largest["speedup"] / 10.0, 4),
        unit="heads/sec",
        mode="head",
        platform=device.type,
        blocks=largest["blocks"],
        epochs=epochs,
        events_per_epoch=events_per_epoch,
        batch=batch,
        seed=seed,
        invalid_rate=invalid_rate,
        orphan_rate=orphan_rate,
        speedup_at_largest=largest["speedup"],
        trees=trees,
        per_mode_best=per_mode_best,
        # SLO state over the replay's chain.apply_batch histogram (the
        # serve objective rides along vacuously when no serve traffic ran)
        slo=slo.global_tracker().bench_section(),
        profile=profiling.summary(),
    )
    if "metrics_scrape_lines" in largest:
        result["metrics_scrape_lines"] = largest["metrics_scrape_lines"]
        result["metrics_chain_lines"] = largest["metrics_chain_lines"]
    return result
