"""The port's chain plane (consensus_specs_tpu_torch/chain/: proto_array,
head_service, metrics, health) against the JAX package's, on the CPU.

Each tier-1 case of tests/test_chain.py, tests/test_chain_service.py and
tests/test_health.py runs on both packages, as one test parametrised over
the package: each package's ``HeadService`` on its own spec, built by its
own builder from its own helpers, with its own ``VerificationService``
(the port's with ``device="cpu"``) over its own ``VerdictBackend``. The
differential gate (proto-array head == ``spec.get_head``) holds after
every batch on both. Then the packages are held to each other: one
gossip stream through both services gives the same head after every
batch, the same routing summaries and the same ``chain.*`` gauges, and
the metric families carry the JAX package's names. The slow cases stay
``slow``. The head-replay bench and the soak scenario wait for their
bench entries.
"""
import json
import random
import types
import urllib.request

import pytest

PKGS = ("jax", "torch")
_ROOTS = {"jax": "consensus_specs_tpu", "torch": "consensus_specs_tpu_torch"}
_SURFACES = {}


def _surface(name):
    """One package's chain surface: its spec (phase0 minimal), the genesis
    of 64 validators from its own helpers, and its chain, serve, obs and
    helper modules."""
    import importlib

    root = _ROOTS[name]
    mod = lambda path: importlib.import_module(f"{root}.{path}")  # noqa
    p = types.SimpleNamespace(name=name)
    p.spec = mod("builder").build_spec_module("phase0", "minimal")
    p.bls = mod("utils.bls")
    chain = mod("chain")
    p.HeadService = chain.HeadService
    p.proto_array = mod("chain.proto_array")
    p.ProtoArray = p.proto_array.ProtoArray
    p.ProtoForkChoice = p.proto_array.ProtoForkChoice
    p.chain_metrics = mod("chain.metrics")
    health = mod("chain.health")
    for n in ("DEFAULT_PARTICIPATION_FLOOR", "GAUGE_LABELS", "HealthLedger",
              "aggregate_summaries", "evaluate_gate"):
        setattr(p, n, getattr(health, n))
    tracing = mod("obs.tracing")
    p.Tracer, p.CHAIN_STAGES = tracing.Tracer, tracing.CHAIN_STAGES
    p.latency = mod("obs.latency")
    p.registry = mod("obs.registry")
    p.start_exposition = mod("obs.exposition").start_exposition
    p.profiling = mod("ops.profiling")
    load = mod("serve.load")
    p.BAD_SIGNATURE = load.BAD_SIGNATURE
    p.VerdictBackend = load.VerdictBackend
    p.plan_gossip_faults = load.plan_gossip_faults
    service_cls = mod("serve.service").VerificationService
    # the port resolves its device at construction: the CPU here
    device_kw = {} if name == "jax" else {"device": "cpu"}
    p.VerificationService = lambda **kw: service_cls(**{**device_kw, **kw})
    att = mod("test.helpers.attestations")
    p.get_valid_attestation = att.get_valid_attestation
    p.next_epoch_with_attestations = att.next_epoch_with_attestations
    blk = mod("test.helpers.block")
    p.build_empty_block_for_next_slot = blk.build_empty_block_for_next_slot
    p.state_transition_and_sign_block = mod(
        "test.helpers.state").state_transition_and_sign_block
    spec = p.spec
    was = p.bls.bls_active
    p.bls.bls_active = True
    try:
        # context.default_balances: 8 validators a slot
        p.genesis = mod("test.helpers.genesis").create_genesis_state(
            spec, [spec.MAX_EFFECTIVE_BALANCE] * (spec.SLOTS_PER_EPOCH * 8),
            spec.MAX_EFFECTIVE_BALANCE)
    finally:
        p.bls.bls_active = was
    return p


def _get(name):
    if name not in _SURFACES:
        _SURFACES[name] = _surface(name)
    return _SURFACES[name]


def _p(spec):
    """The surface of the package that built ``spec``."""
    return _get("torch" if spec.__name__.startswith(_ROOTS["torch"] + ".")
                else "jax")


@pytest.fixture(params=PKGS)
def p(request):
    return _get(request.param)


@pytest.fixture
def spec(p):
    return p.spec


@pytest.fixture
def genesis_state(p):
    return p.genesis.copy()


@pytest.fixture(autouse=True)
def _switchboards():
    """Histories are built with both stubbed switchboards (the reference's
    `make test` posture); service-routing tests flip the flag on
    themselves. The port's eager checks use the CPU oracle, and every
    flag, backend and profiling surface comes back after."""
    from consensus_specs_tpu.ops import profiling as jprofiling
    from consensus_specs_tpu.utils import bls as jbls
    from consensus_specs_tpu_torch.ops import profiling as tprofiling
    from consensus_specs_tpu_torch.utils import bls as tbls

    was = (jbls.bls_active, tbls.bls_active, tbls._backend)
    jbls.bls_active = tbls.bls_active = False
    tbls.use_py_ecc()
    jprofiling.reset()
    tprofiling.reset()
    yield
    jbls.bls_active, tbls.bls_active, tbls._backend = was
    jprofiling.reset()
    tprofiling.reset()


# -- the differential mirror (tests/test_chain.py) ---------------------------


class Mirror:
    """One event stream, two fork choices: every mutation lands in the
    spec ``Store`` (oracle) and the package's ``ProtoForkChoice``
    (production), and ``check()`` asserts their heads agree."""

    def __init__(self, spec, genesis_state, rng):
        self.spec = spec
        self.rng = rng
        self.anchor_state = genesis_state.copy()
        self.anchor_block = spec.BeaconBlock(
            state_root=self.anchor_state.hash_tree_root())
        self.store = spec.get_forkchoice_store(self.anchor_state,
                                               self.anchor_block)
        self.anchor_root = spec.hash_tree_root(self.anchor_block)
        self.fc = _p(spec).ProtoForkChoice()
        anchor_stored = self.store.block_states[self.anchor_root]
        self.fc.on_block(
            bytes(self.anchor_root), None, 0,
            self._cp(anchor_stored.current_justified_checkpoint),
            self._cp(anchor_stored.finalized_checkpoint),
        )
        self.roots = [self.anchor_root]
        self.refresh()

    @staticmethod
    def _cp(checkpoint):
        return (int(checkpoint.epoch), bytes(checkpoint.root))

    def refresh(self):
        spec, store = self.spec, self.store
        state = store.checkpoint_states[store.justified_checkpoint]
        active = spec.get_active_validator_indices(
            state, spec.get_current_epoch(state))
        balances = {
            int(i): int(state.validators[i].effective_balance) for i in active
        }
        return self.fc.update_checkpoints(
            self._cp(store.justified_checkpoint),
            self._cp(store.finalized_checkpoint), balances)

    def add_block(self, parent_root, slot, justified_cp=None,
                  finalized_cp=None):
        spec = self.spec
        block = spec.BeaconBlock(
            slot=slot,
            parent_root=parent_root,
            state_root=self.rng.getrandbits(256).to_bytes(32, "little"),
        )
        root = spec.hash_tree_root(block)
        state = self.anchor_state.copy()
        if justified_cp is not None:
            state.current_justified_checkpoint = justified_cp
        if finalized_cp is not None:
            state.finalized_checkpoint = finalized_cp
        self.store.blocks[root] = block
        self.store.block_states[root] = state
        self.fc.on_block(bytes(root), bytes(parent_root), int(slot),
                         self._cp(state.current_justified_checkpoint),
                         self._cp(state.finalized_checkpoint))
        self.roots.append(root)
        return root

    def vote(self, validator, root, epoch):
        spec, store = self.spec, self.store
        existing = store.latest_messages.get(spec.ValidatorIndex(validator))
        if existing is None or epoch > existing.epoch:
            store.latest_messages[spec.ValidatorIndex(validator)] = \
                spec.LatestMessage(epoch=spec.Epoch(epoch),
                                   root=spec.Root(root))
        self.fc.on_latest_message(int(validator), bytes(root), int(epoch))

    def move_justified(self, epoch, root, balance_shuffle=False):
        spec = self.spec
        cp = spec.Checkpoint(epoch=epoch, root=root)
        state = self.anchor_state.copy()
        if balance_shuffle:
            for i in range(0, len(state.validators), 3):
                state.validators[i].effective_balance = \
                    spec.EFFECTIVE_BALANCE_INCREMENT * (1 + i % 7)
            state.validators[1].exit_epoch = spec.Epoch(0)
            state.validators[5].exit_epoch = spec.Epoch(0)
        self.store.checkpoint_states[cp] = state
        self.store.justified_checkpoint = cp
        return self.refresh()

    def move_finalized(self, epoch, root):
        self.store.finalized_checkpoint = self.spec.Checkpoint(
            epoch=epoch, root=root)
        return self.refresh()

    def check(self):
        self.fc.apply()
        proto = self.fc.head()
        oracle = bytes(self.spec.get_head(self.store))
        assert proto == oracle, (
            f"head diverged: proto={proto.hex()[:16]} "
            f"oracle={oracle.hex()[:16]} over {len(self.roots)} blocks"
        )
        return proto


def _grow_tree(m, rng, blocks, max_slot, spine, agree=0.6):
    cp1 = m.spec.Checkpoint(epoch=1, root=spine)
    by_slot = {0: [m.anchor_root], 1: [spine]}
    for _ in range(blocks):
        slot = rng.randint(1, max_slot)
        earlier = [s for s in by_slot if s < slot]
        parent = rng.choice(by_slot[rng.choice(earlier)])
        root = m.add_block(
            parent, slot,
            justified_cp=cp1 if rng.random() < agree else None,
            finalized_cp=cp1 if rng.random() < agree else None,
        )
        by_slot.setdefault(slot, []).append(root)


def _run_differential(spec, genesis_state, seed, blocks, vote_events,
                      check_every=1):
    rng = random.Random(seed)
    m = Mirror(spec, genesis_state, rng)
    n_validators = len(genesis_state.validators)
    spine = m.add_block(m.anchor_root, 1)
    _grow_tree(m, rng, blocks, max_slot=24, spine=spine)
    m.check()

    batch, applied = [], 0
    checks = 0
    for e in range(vote_events):
        batch.append((rng.randrange(n_validators), rng.choice(m.roots),
                      rng.randint(0, 4)))
        if len(batch) >= 8:
            for v, r, ep in batch:
                m.vote(v, r, ep)
            applied += len(batch)
            batch = []
            checks += 1
            if checks % check_every == 0:
                m.check()
        if e == vote_events // 3:
            m.move_justified(1, spine, balance_shuffle=True)
            m.check()
        if e == (2 * vote_events) // 3:
            before = m.fc.block_count
            m.move_finalized(1, spine)
            pruned = before - m.fc.block_count
            assert pruned > 0
            m.check()
    for v, r, ep in batch:
        m.vote(v, r, ep)
    m.check()
    assert applied > 0


def _twin_of(fc):
    """A second fork choice replaying the same tree + checkpoints."""
    twin = type(fc)()
    for node in fc.array._nodes:
        parent_root = (fc.array._nodes[node.parent].root
                       if node.parent is not None else None)
        twin.on_block(node.root, parent_root, node.slot,
                      node.justified_checkpoint, node.finalized_checkpoint)
    twin.update_checkpoints(fc._justified, fc._finalized,
                            dict(fc._balances))
    return twin


def _weights(fc):
    return {n.root: n.weight for n in fc.array._nodes}


# -- the HeadService helpers (tests/test_chain_service.py) -------------------


def _service(spec, genesis_state, **kw):
    state = genesis_state.copy()
    anchor_block = spec.BeaconBlock(state_root=state.hash_tree_root())
    head = _p(spec).HeadService(spec, state, anchor_block, **kw)
    return head, state


def _tick_to(spec, head, slot):
    store = head.store
    for s in range(int(spec.get_current_slot(store)) + 1, int(slot) + 1):
        head.on_tick(store.genesis_time + s * int(spec.config.SECONDS_PER_SLOT))


def _fork_pair(spec, base_state, tag_a=b"\x01", tag_b=b"\x02"):
    """Two competing siblings on the next slot."""
    p = _p(spec)
    state_a, state_b = base_state.copy(), base_state.copy()
    block_a = p.build_empty_block_for_next_slot(spec, state_a)
    block_a.body.graffiti = spec.Bytes32(tag_a * 32)
    signed_a = p.state_transition_and_sign_block(spec, state_a, block_a)
    block_b = p.build_empty_block_for_next_slot(spec, state_b)
    block_b.body.graffiti = spec.Bytes32(tag_b * 32)
    signed_b = p.state_transition_and_sign_block(spec, state_b, block_b)
    return (state_a, signed_a), (state_b, signed_b)


def _routed_service(spec, genesis_state):
    """A HeadService over a VerificationService whose verdicts are
    carried by the signature bytes (serve/load.py VerdictBackend)."""
    p = _p(spec)
    backend = p.VerdictBackend()
    svc = p.VerificationService(backend=backend, max_batch=16,
                                max_wait_ms=2.0)
    head, state = _service(spec, genesis_state, service=svc,
                           differential=True)
    return head, state, svc, backend


# -- the stubbed HeadService surface (tests/test_health.py) -------------------


class _Spec:
    SLOTS_PER_EPOCH = 8

    def get_current_slot(self, store):
        return store.current_slot

    def compute_start_slot_at_epoch(self, epoch):
        return epoch * self.SLOTS_PER_EPOCH


class _Checkpoint:
    def __init__(self, epoch):
        self.epoch = epoch


class _Store:
    def __init__(self):
        self.current_slot = 0
        self.finalized_checkpoint = _Checkpoint(0)


class _ForkChoice:
    def __init__(self):
        self._balances = {}
        self.votes = {}


class _Metrics:
    def __init__(self):
        self._c = {"head_changes": 0, "reorgs": 0, "rollbacks": 0,
                   "last_reorg_depth": 0}

    def counters(self):
        return dict(self._c)


class _FakeHead:
    """The minimal HeadService surface the ledger reads."""

    def __init__(self):
        self.spec = _Spec()
        self.store = _Store()
        self.fc = _ForkChoice()
        self.metrics = _Metrics()
        self.deferred_count = 0


def _vote(head, validator, balance, voted=True):
    head.fc._balances[validator] = balance
    if voted:
        head.fc.votes[validator] = object()



# -- the cases of tests/test_chain.py


def test_differential_small_trees(p, spec, genesis_state):
    for seed in (1, 2, 3, 4):
        _run_differential(spec, genesis_state, seed, blocks=20,
                          vote_events=48)


def test_differential_bushy_tie_breaks(p, spec, genesis_state):
    # zero-weight sibling forests everywhere: the lexicographic tie-break
    # is the only signal, and it must match the spec's max(weight, root)
    rng = random.Random(99)
    m = Mirror(spec, genesis_state, rng)
    for slot in (1, 2, 3):
        for _ in range(4):
            m.add_block(m.anchor_root, slot)
        m.check()
    # one vote flips the whole forest to the voted branch
    m.vote(0, m.roots[5], 1)
    m.check()


def test_latest_message_rule(p, spec, genesis_state):
    # a same-epoch vote must NOT displace; a newer-epoch vote must
    rng = random.Random(5)
    m = Mirror(spec, genesis_state, rng)
    a = m.add_block(m.anchor_root, 1)
    b = m.add_block(m.anchor_root, 1)
    m.vote(0, a, 1)
    assert m.check() == bytes(a)
    m.vote(0, b, 1)  # same epoch: must NOT displace
    assert m.check() == bytes(a)
    m.vote(0, b, 2)  # newer epoch: must move
    assert m.check() == bytes(b)


def test_viability_filters_nonmatching_leaves(p, spec, genesis_state):
    """A branch whose leaf state disagrees with the store's justified
    checkpoint must lose to a viable branch regardless of weight — and
    when NO leaf is viable, the head collapses to the justified root."""
    rng = random.Random(6)
    m = Mirror(spec, genesis_state, rng)
    good_cp = spec.Checkpoint(epoch=1, root=m.anchor_root)
    stale_cp = spec.Checkpoint(epoch=1,
                               root=spec.Root(b"\x42" * 32))
    viable = m.add_block(m.anchor_root, 1, justified_cp=good_cp)
    heavy = m.add_block(m.anchor_root, 1, justified_cp=stale_cp)
    for v in range(8):
        m.vote(v, heavy, 1)
    m.move_justified(1, m.anchor_root)
    head = m.check()
    assert head == viable  # the heavy branch is filtered out
    # drop the last viable leaf's agreement too: justified root wins
    m.move_justified(2, m.anchor_root)
    head = m.check()
    assert head == bytes(m.anchor_root)


def test_pruning_keeps_heads_and_shrinks(p, spec, genesis_state):
    rng = random.Random(7)
    m = Mirror(spec, genesis_state, rng)
    keep_root = m.add_block(m.anchor_root, 1)
    cp1 = spec.Checkpoint(epoch=1, root=keep_root)
    trunk = keep_root
    side_roots = []
    for slot in range(2, 8):
        trunk = m.add_block(trunk, slot, justified_cp=cp1, finalized_cp=cp1)
        side_roots.append(m.add_block(m.anchor_root, slot))  # pruned later
    m.check()
    before = m.fc.block_count
    m.move_finalized(1, keep_root)
    m.move_justified(1, keep_root)
    assert m.fc.block_count < before
    head = m.check()
    assert head == bytes(trunk)  # the agreeing trunk leaf wins post-prune
    # votes referencing pruned side branches must be inert, not fatal
    m.vote(0, side_roots[0], 3)
    m.check()


def test_speculative_rollback_differential(p, spec, genesis_state):
    """Randomized speculative-apply/rollback sequences: a speculating
    twin applies EVERY batch's votes before "verdicts", rolls the whole
    batch back whenever a random subset "fails", and re-applies the
    passing votes — after every batch
    its weights, head, and vote table must be bit-identical to the
    never-speculated Mirror (which itself stays differential against
    ``spec.get_head``). Repeated validators inside one batch exercise
    the LIFO displacement-chain unwind."""
    rng = random.Random(31)
    m = Mirror(spec, genesis_state, rng)
    spine = m.add_block(m.anchor_root, 1)
    _grow_tree(m, rng, 24, max_slot=24, spine=spine)
    m.check()
    twin = _twin_of(m.fc)
    n_validators = len(genesis_state.validators)

    for batch_i in range(12):
        # small validator pool => frequent intra-batch repeats
        votes = [(rng.randrange(min(8, n_validators)), rng.choice(m.roots),
                  rng.randint(0, 4)) for _ in range(8)]
        failing = {i for i in range(len(votes)) if rng.random() < 0.35}

        # speculating side: apply ALL votes, sweep (the speculative head
        # exists and is never consulted by the oracle), then roll back
        # everything on any failure and re-apply only the passing ones
        tokens = []
        for v, r, ep in votes:
            _applied, tok = twin.speculate_latest_message(int(v), bytes(r),
                                                          ep)
            if tok is not None:
                tokens.append(tok)
        twin.apply()
        if failing:
            twin.rollback_latest_messages(tokens)
            for i, (v, r, ep) in enumerate(votes):
                if i not in failing:
                    twin.on_latest_message(int(v), bytes(r), ep)

        # oracle side: only the passing votes ever existed
        for i, (v, r, ep) in enumerate(votes):
            if i not in failing:
                m.vote(v, r, ep)

        if batch_i == 5:
            # a checkpoint move with a perturbed balance set BETWEEN
            # batches (the service contract: never inside one)
            m.move_justified(1, spine, balance_shuffle=True)
            twin.update_checkpoints(m.fc._justified, m.fc._finalized,
                                    dict(m.fc._balances))
        if batch_i == 8:
            m.move_finalized(1, spine)
            twin.update_checkpoints(m.fc._justified, m.fc._finalized,
                                    dict(m.fc._balances))

        twin.apply()
        head = m.check()  # Mirror vs spec.get_head stays the outer gate
        assert twin.head() == head
        assert _weights(twin) == _weights(m.fc)
        assert twin.votes == m.fc.votes


def test_rollback_unwinds_intra_batch_displacement_chain(p):
    """One validator speculated twice in one batch (epoch 2 then 3):
    rolling back must restore the ORIGINAL vote, not the intermediate."""
    fc = p.ProtoForkChoice()
    a, b, c = b"a" * 32, b"b" * 32, b"c" * 32
    fc.on_block(a, None, 0, (0, b""), (0, b""))
    fc.on_block(b, a, 1, (0, b""), (0, b""))
    fc.on_block(c, a, 1, (0, b""), (0, b""))
    fc.update_checkpoints((0, a), (0, b""), {0: 100})
    fc.on_latest_message(0, b, 1)
    fc.apply()
    assert fc.head() == b
    before = _weights(fc)
    tokens = []
    for root, epoch in ((c, 2), (b, 3)):
        _applied, tok = fc.speculate_latest_message(0, root, epoch)
        tokens.append(tok)
    assert fc.votes[0] == (b, 3)
    assert fc.rollback_latest_messages(tokens) == 2
    fc.apply()
    assert fc.votes[0] == (b, 1)  # the pre-batch vote, not (c, 2)
    assert _weights(fc) == before
    assert fc.head() == b


def test_insert_contract(p):
    arr = p.ProtoArray()
    arr.insert(b"a" * 32, None, 0, (0, b""), (0, b""))
    arr.insert(b"b" * 32, b"a" * 32, 1, (0, b""), (0, b""))
    arr.insert(b"b" * 32, b"a" * 32, 1, (0, b""), (0, b""))  # dup: no-op
    assert len(arr) == 2
    with pytest.raises(KeyError):
        arr.insert(b"c" * 32, b"zz" * 16, 2, (0, b""), (0, b""))
    arr.add_delta(b"missing" * 4 + b"e" * 4, 100)  # swallowed
    arr.apply((0, b""), (0, b""))
    assert arr.head(b"a" * 32) == b"b" * 32


def test_reorg_depth_walk(p):
    arr = p.ProtoArray()
    arr.insert(b"a" * 32, None, 0, (0, b""), (0, b""))
    arr.insert(b"b" * 32, b"a" * 32, 1, (0, b""), (0, b""))
    arr.insert(b"c" * 32, b"b" * 32, 2, (0, b""), (0, b""))
    arr.insert(b"d" * 32, b"a" * 32, 3, (0, b""), (0, b""))
    # c -> d forks at a: rolls back c's 2 slots
    assert arr.reorg_depth(b"c" * 32, b"d" * 32) == 2
    # extension is not a reorg
    assert arr.reorg_depth(b"b" * 32, b"c" * 32) == 0
    assert arr.reorg_depth(b"x" * 32, b"c" * 32) == 0  # unknown: 0


def test_prune_rebuild_indices(p):
    arr = p.ProtoArray()
    arr.insert(b"a" * 32, None, 0, (0, b""), (0, b""))
    arr.insert(b"b" * 32, b"a" * 32, 1, (0, b""), (0, b""))
    arr.insert(b"s" * 32, b"a" * 32, 1, (0, b""), (0, b""))
    arr.insert(b"c" * 32, b"b" * 32, 2, (0, b""), (0, b""))
    dropped = arr.prune(b"b" * 32)
    assert dropped == 2 and len(arr) == 2
    assert b"s" * 32 not in arr and b"a" * 32 not in arr
    arr.apply((0, b""), (0, b""))
    assert arr.head(b"b" * 32) == b"c" * 32


@pytest.mark.slow
def test_differential_wide_trees_slow(p, spec, genesis_state):
    """64+-block trees, >1k latest-message updates, checkpoint moves and
    pruning — the full-width differential gate."""
    for seed in (11, 12, 13):
        _run_differential(spec, genesis_state, seed, blocks=96,
                          vote_events=400, check_every=1)


@pytest.mark.slow
def test_differential_deep_churn_slow(p, spec, genesis_state):
    # a 160-block tree under sustained vote churn across 5 epochs
    _run_differential(spec, genesis_state, 21, blocks=160, vote_events=640)


# -- the cases of tests/test_chain_service.py


def test_real_history_differential(p, spec, genesis_state):
    """Three epochs of blocks-with-attestations (justified checkpoint
    moves), then a two-sibling fork flipped by a gossip vote — the inline
    differential assert runs after EVERY block and batch."""
    head, _ = _service(spec, genesis_state, differential=True)
    state = genesis_state.copy()
    for _ in range(3):
        _, signed_blocks, state = p.next_epoch_with_attestations(
            spec, state, True, False)
        for sb in signed_blocks:
            _tick_to(spec, head, sb.message.slot)
            head.on_block(sb)
    assert int(head.store.justified_checkpoint.epoch) > 0
    assert bytes(spec.get_head(head.store)) == bytes(head.get_head())

    (state_a, signed_a), (state_b, signed_b) = _fork_pair(spec, state)
    _tick_to(spec, head, signed_a.message.slot)
    head.on_block(signed_a)
    head.on_block(signed_b)
    root_a = spec.hash_tree_root(signed_a.message)
    root_b = spec.hash_tree_root(signed_b.message)
    tie = head.get_head()
    assert tie in (root_a, root_b)
    loser_state, loser_signed, loser_root = (
        (state_a, signed_a, root_a) if tie == root_b
        else (state_b, signed_b, root_b))
    att = p.get_valid_attestation(
        spec, loser_state, slot=loser_signed.message.slot, signed=False,
        beacon_block_root=loser_root)
    _tick_to(spec, head, loser_signed.message.slot + 1)
    summary = head.on_attestations([att])
    assert summary["applied"] > 0
    assert head.get_head() == loser_root
    snap = head.metrics.snapshot()
    assert snap["reorgs"] >= 1 and snap["head_changes"] >= 2


@pytest.mark.slow
def test_real_history_finalization_prunes_slow(p, spec, genesis_state):
    """Five epochs with current+previous-epoch attestations: the store
    FINALIZES on the validated path, the proto-array prunes, and the
    differential assert holds throughout."""
    head, _ = _service(spec, genesis_state, differential=True)
    state = genesis_state.copy()
    for epoch in range(5):
        prev = epoch > 1
        _, signed_blocks, state = p.next_epoch_with_attestations(
            spec, state, True, prev)
        for sb in signed_blocks:
            _tick_to(spec, head, sb.message.slot)
            head.on_block(sb)
    assert int(head.store.finalized_checkpoint.epoch) > 0
    assert head.metrics.snapshot()["pruned_nodes"] > 0
    assert bytes(spec.get_head(head.store)) == bytes(head.get_head())


def test_service_routes_verdicts(p, spec, genesis_state):
    """Valid signatures apply; BAD_SIGNATURE comes back False from the
    service and the attestation is dropped WITHOUT touching either fork
    choice — while the spec store and proto array stay head-identical."""
    head, state, svc, backend = _routed_service(spec, genesis_state)
    try:
        (state_a, signed_a), (state_b, signed_b) = _fork_pair(spec, state)
        _tick_to(spec, head, signed_a.message.slot)
        head.on_block(signed_a)
        head.on_block(signed_b)
        root_a = spec.hash_tree_root(signed_a.message)
        root_b = spec.hash_tree_root(signed_b.message)
        tie = head.get_head()
        loser_state, loser_signed, loser_root = (
            (state_a, signed_a, root_a) if tie == root_b
            else (state_b, signed_b, root_b))
        _tick_to(spec, head, loser_signed.message.slot + 1)

        p.bls.bls_active = True  # verdicts must flow through the service
        bad = p.get_valid_attestation(
            spec, loser_state, slot=loser_signed.message.slot, signed=False,
            beacon_block_root=loser_root)
        bad.signature = spec.BLSSignature(p.BAD_SIGNATURE)
        summary = head.on_attestations([bad])
        assert summary == {"applied": 0, "stale": 0, "deferred": 0,
                           "dropped": 1, "resolved": 0}
        assert head.get_head() == tie  # nothing moved
        assert not head.store.latest_messages

        good = p.get_valid_attestation(
            spec, loser_state, slot=loser_signed.message.slot, signed=False,
            beacon_block_root=loser_root)
        summary = head.on_attestations([good])
        assert summary["applied"] > 0 and summary["dropped"] == 0
        assert head.get_head() == loser_root
        assert backend.calls > 0  # the verdicts really came from the backend
    finally:
        svc.close(timeout=30)


def test_unknown_block_defers_then_resolves(p, spec, genesis_state):
    """Gossip for a block the store has not seen parks in the deferral
    buffer and applies when the block arrives — the spec's 'delay
    consideration' rule, end to end through the service."""
    head, state, svc, _ = _routed_service(spec, genesis_state)
    try:
        fork_state = state.copy()
        block = p.build_empty_block_for_next_slot(spec, fork_state)
        signed = p.state_transition_and_sign_block(spec, fork_state, block)
        root = spec.hash_tree_root(block)
        att = p.get_valid_attestation(spec, fork_state, slot=block.slot,
                                    signed=False, beacon_block_root=root)
        _tick_to(spec, head, block.slot + 1)

        p.bls.bls_active = True
        summary = head.on_attestations([att])
        assert summary["deferred"] == 1 and head.deferred_count == 1
        assert head.metrics.snapshot()["deferred_pending"] == 1

        p.bls.bls_active = False  # the block path verifies inline
        head.on_block(signed)  # arrival retries the deferred gossip
        snap = head.metrics.snapshot()
        assert snap["resolved"] == 1 and snap["deferred_pending"] == 0
        assert head.get_head() == root
    finally:
        svc.close(timeout=30)


def test_deferred_attestation_survives_unrelated_blocks(p, spec, genesis_state):
    """The order-independence regression (simnet reordering): an
    attestation heard before its block must survive MORE unrelated block
    arrivals than its whole retry budget, then still apply the moment its
    own block lands via a different peer."""
    head, state = _service(spec, genesis_state, defer_retries=2)
    # the attested fork block, withheld from the service for now
    fork_state = state.copy()
    block = p.build_empty_block_for_next_slot(spec, fork_state)
    block.body.graffiti = spec.Bytes32(b"\x07" * 32)
    signed = p.state_transition_and_sign_block(spec, fork_state, block)
    root = spec.hash_tree_root(block)
    att = p.get_valid_attestation(spec, fork_state, slot=block.slot,
                                signed=False, beacon_block_root=root)
    _tick_to(spec, head, block.slot + 1)
    summary = head.on_attestations([att])
    assert summary["deferred"] == 1 and head.deferred_count == 1

    # five unrelated main-chain blocks arrive — far past defer_retries=2.
    # None of them resolves the entry, so none may consume its budget
    # (and the interleaved clock ticks re-examine it uncharged)
    st = state.copy()
    for _ in range(5):
        sb = p.state_transition_and_sign_block(
            spec, st, p.build_empty_block_for_next_slot(spec, st))
        _tick_to(spec, head, sb.message.slot)
        head.on_block(sb)
    assert head.deferred_count == 1, "unrelated arrivals evicted the entry"

    # the attested block finally arrives via "a different peer"
    head.on_block(signed)
    snap = head.metrics.snapshot()
    assert snap["resolved"] == 1 and snap["deferred_pending"] == 0
    assert head.store.latest_messages  # the vote applied
    assert bytes(spec.get_head(head.store)) == bytes(head.get_head())


def test_deferred_block_vs_attestation_order_is_irrelevant(p, spec, genesis_state):
    """Same gossip, two delivery orders (block-then-attestation vs
    attestation-then-block): identical head and latest messages."""
    fork_state = genesis_state.copy()
    block = p.build_empty_block_for_next_slot(spec, fork_state)
    signed = p.state_transition_and_sign_block(spec, fork_state, block)
    root = spec.hash_tree_root(block)

    def run(block_first: bool):
        head, _ = _service(spec, genesis_state)
        att = p.get_valid_attestation(spec, fork_state.copy(),
                                    slot=block.slot, signed=False,
                                    beacon_block_root=root)
        _tick_to(spec, head, block.slot + 1)
        if block_first:
            head.on_block(signed)
            head.on_attestations([att])
        else:
            head.on_attestations([att])
            head.on_block(signed)
        table = {
            int(i): (int(m.epoch), bytes(m.root))
            for i, m in head.store.latest_messages.items()
        }
        return bytes(head.get_head()), table

    head_a, votes_a = run(block_first=True)
    head_b, votes_b = run(block_first=False)
    assert head_a == head_b == bytes(root)
    assert votes_a == votes_b and votes_a


def test_stale_deferred_entries_evict_via_epoch_window(p, spec, genesis_state):
    """An entry whose block never arrives is evicted by the spec's
    stale-epoch rule as the clock advances — not leaked, not charged to
    unrelated arrivals."""
    head, state = _service(spec, genesis_state)
    never_known = spec.Root(b"\x77" * 32)
    att = p.get_valid_attestation(spec, state.copy(), slot=state.slot,
                                signed=False)
    att.data.beacon_block_root = never_known
    _tick_to(spec, head, state.slot + 2)
    summary = head.on_attestations([att])
    assert summary["deferred"] == 1
    # clock to epoch 3: target epoch 0 leaves the {current, previous}
    # window and the tick's (uncharged) re-route drops the entry
    _tick_to(spec, head, int(spec.SLOTS_PER_EPOCH) * 3)
    assert head.deferred_count == 0
    assert head.metrics.snapshot()["dropped"] == 1


def test_time_gated_deferrals_charge_retries(p, spec, genesis_state):
    """Entries gated on the CLOCK (far-future target epoch) spend one
    retry per slot tick — the budget still bounds time-gated spinning."""
    head, state = _service(spec, genesis_state, defer_retries=2)
    att = p.get_valid_attestation(spec, state.copy(), slot=state.slot,
                                signed=False)
    att.data.target.epoch = spec.Epoch(64)  # far future: never applies
    summary = head.on_attestations([att])
    assert summary["deferred"] == 1
    _tick_to(spec, head, state.slot + 1)  # retry 1 -> re-defer (charged)
    assert head.deferred_count == 1
    _tick_to(spec, head, state.slot + 2)  # retry 2 -> budget exhausted
    assert head.deferred_count == 0
    assert head.metrics.snapshot()["dropped"] == 1


def test_stale_epoch_attestation_drops(p, spec, genesis_state):
    head, state = _service(spec, genesis_state)
    att = p.get_valid_attestation(spec, state.copy(), slot=state.slot,
                                signed=False)
    # clock far ahead: target epoch 0 is neither current nor previous
    _tick_to(spec, head, int(spec.SLOTS_PER_EPOCH) * 3)
    summary = head.on_attestations([att])
    assert summary == {"applied": 0, "stale": 0, "deferred": 0,
                       "dropped": 1, "resolved": 0}


def test_chain_gauges_and_exposition(p, spec, genesis_state):
    """The chain.* family lands in profiling.summary() and renders on a
    live /metrics endpoint; /snapshot serves the ChainMetrics snapshot."""
    start_exposition = p.start_exposition

    p.profiling.reset()
    head, state = _service(spec, genesis_state, differential=True)
    st = state.copy()
    signed = p.state_transition_and_sign_block(
        spec, st, p.build_empty_block_for_next_slot(spec, st))
    _tick_to(spec, head, signed.message.slot)
    head.on_block(signed)

    snap = p.profiling.summary()
    GAUGE_LABELS = p.chain_metrics.GAUGE_LABELS

    for label in GAUGE_LABELS:
        assert label in snap, f"{label} missing from profiling summary"
    assert snap["chain.blocks"]["gauge"] == 2.0  # anchor + one block

    with start_exposition(snapshot_fn=head.metrics.snapshot) as server:
        with urllib.request.urlopen(server.url("/metrics"), timeout=10) as r:
            body = r.read().decode()
        chain_lines = [ln for ln in body.splitlines()
                       if ln.startswith("consensus_specs_tpu_chain_")]
        assert len(chain_lines) >= len(GAUGE_LABELS)
        with urllib.request.urlopen(server.url("/snapshot"), timeout=10) as r:
            snapshot = json.loads(r.read().decode())
        assert snapshot["blocks"] == 1 and "apply_latency" in snapshot


def test_batch_spans_traced(p, spec, genesis_state):
    tracer = p.Tracer(capacity=64)
    head, state = _service(spec, genesis_state, tracer=tracer)
    att = p.get_valid_attestation(spec, state.copy(), slot=state.slot,
                                signed=False)
    _tick_to(spec, head, state.slot + 1)
    head.on_attestations([att])
    done = [t for t in tracer.completed() if t.kind == "chain_apply"]
    assert done, "no chain_apply trace finished"
    names = done[-1].span_names()
    assert set(p.CHAIN_STAGES) <= names


def test_gossip_fault_plan_shape(p):
    rng = random.Random(3)
    plan = p.plan_gossip_faults(rng, 200, invalid_rate=0.2, orphan_rate=0.2)
    assert plan[0] == "ok"  # the stream never starts with a fault
    kinds = set(plan)
    assert kinds == {"ok", "invalid_sig", "orphan"}
    assert plan.count("invalid_sig") + plan.count("orphan") < 120


def test_verdict_backend_contract(p):
    backend = p.VerdictBackend()
    out = backend.batch_fast_aggregate_verify(
        [[b"k"], [b"k"]], [b"m", b"m"], [b"\x01" * 96, p.BAD_SIGNATURE])
    assert out == [True, False]
    assert backend.calls == 1 and backend.items == 2


# -- the cases of tests/test_health.py


def test_participation_is_balance_weighted(p):
    head = _FakeHead()
    _vote(head, 0, 32, voted=True)
    _vote(head, 1, 32, voted=True)
    _vote(head, 2, 96, voted=False)  # one heavy abstainer
    rec = p.HealthLedger(head).observe_slot(slot=5)
    assert rec["participation_rate"] == pytest.approx(64 / 160)
    assert rec["slot"] == 5


def test_empty_validator_set_reads_zero_not_crash(p):
    rec = p.HealthLedger(_FakeHead()).observe_slot(slot=0)
    assert rec["participation_rate"] == 0.0


def test_finality_lag_is_slots_past_finalized_epoch_start(p):
    head = _FakeHead()
    head.store.finalized_checkpoint = _Checkpoint(2)  # start slot 16
    led = p.HealthLedger(head)
    assert led.observe_slot(slot=18)["finality_lag_slots"] == 2
    assert led.observe_slot(slot=40)["finality_lag_slots"] == 24
    # finalized ahead of the queried slot clamps at 0, never negative
    assert led.observe_slot(slot=10)["finality_lag_slots"] == 0
    assert led.summary()["finality_lag_max"] == 24


def test_counter_deltas_not_cumulatives_per_slot(p):
    head = _FakeHead()
    led = p.HealthLedger(head)
    head.metrics._c.update(head_changes=3, rollbacks=1)
    rec = led.observe_slot(slot=1)
    assert rec["head_churn"] == 3 and rec["rollback_rate"] == 1
    # no movement next slot: deltas read 0, totals hold
    rec = led.observe_slot(slot=2)
    assert rec["head_churn"] == 0 and rec["rollback_rate"] == 0
    assert led.head_churn_total == 3 and led.rollbacks_total == 1


def test_unexplained_reorgs_only_accumulate_outside_declared_windows(p):
    head = _FakeHead()
    led = p.HealthLedger(head)
    # a reorg inside a declared disruption window: explained
    head.metrics._c.update(reorgs=1, last_reorg_depth=2)
    rec = led.observe_slot(slot=1, expect_reorgs=True)
    assert rec["unexplained_reorgs"] == 0 and rec["reorg_depth"] == 2
    # the same movement outside any window: counted, and it sticks
    head.metrics._c.update(reorgs=3, last_reorg_depth=5)
    rec = led.observe_slot(slot=2, expect_reorgs=False)
    assert rec["unexplained_reorgs"] == 2
    assert led.summary()["unexplained_reorgs"] == 2
    assert led.summary()["reorgs_total"] == 3
    assert led.summary()["reorg_depth_max"] == 5


def test_reorg_depth_reads_zero_when_head_only_extended(p):
    head = _FakeHead()
    head.metrics._c.update(last_reorg_depth=7)  # stale depth, no reorg
    assert p.HealthLedger(head).observe_slot(slot=1)["reorg_depth"] == 0


def test_gauges_export_under_node_label(p):
    head = _FakeHead()
    _vote(head, 0, 32)
    p.HealthLedger(head, node="n2").observe_slot(slot=3)
    gauges = p.profiling.stats_and_gauges()[1]
    for label in p.GAUGE_LABELS:
        name = label.split("health.", 1)[1]
        assert f"health[n2].{name}" in gauges, f"missing {name}"
    assert gauges["health[n2].participation_rate"] == 1.0
    # bare (node=None) form uses the registered base names
    p.HealthLedger(head).observe_slot(slot=3)
    gauges = p.profiling.stats_and_gauges()[1]
    assert "health.participation_rate" in gauges


def test_record_window_is_bounded_but_extremes_are_cumulative(p):
    head = _FakeHead()
    led = p.HealthLedger(head, window=4)
    _vote(head, 0, 32)
    head.store.finalized_checkpoint = _Checkpoint(0)
    for slot in range(10):
        led.observe_slot(slot=slot)
    assert len(led.records()) == 4
    assert led.summary()["slots_observed"] == 10
    # the max lag happened before the ring dropped it; summary keeps it
    assert led.summary()["finality_lag_max"] == 9


def test_aggregate_summaries_takes_the_worst_case_per_bound(p):
    a = {"slots_observed": 10, "participation_min": 0.9,
         "participation_mean": 0.95, "participation_last": 0.92,
         "finality_lag_max": 4, "finality_lag_last": 2,
         "reorg_depth_max": 1, "reorgs_total": 2, "unexplained_reorgs": 0,
         "head_churn_total": 5, "rollbacks_total": 1,
         "deferral_depth_max": 3}
    b = dict(a, participation_min=0.7, finality_lag_max=30,
             unexplained_reorgs=1, reorgs_total=1)
    agg = p.aggregate_summaries([a, b])
    assert agg["participation_min"] == 0.7     # min across nodes
    assert agg["finality_lag_max"] == 30       # max across nodes
    assert agg["unexplained_reorgs"] == 1      # sums
    assert agg["reorgs_total"] == 3
    assert p.aggregate_summaries([])["slots_observed"] == 0


def test_gate_verdicts_and_reasons(p):
    head = _FakeHead()
    _vote(head, 0, 32)
    led = p.HealthLedger(head)
    for slot in range(4):
        led.observe_slot(slot=slot)
    ok = p.evaluate_gate(led.summary())
    assert ok["ok"] and ok["reasons"] == []
    assert ok["participation_floor"] == p.DEFAULT_PARTICIPATION_FLOOR
    # each bound trips independently, with a legible reason string
    sick = dict(led.summary(), participation_min=0.1,
                finality_lag_max=999, unexplained_reorgs=2)
    verdict = p.evaluate_gate(sick)
    assert not verdict["ok"] and len(verdict["reasons"]) == 3
    assert any("participation_min" in r for r in verdict["reasons"])
    assert any("finality_lag_max" in r for r in verdict["reasons"])
    assert any("unexplained_reorgs" in r for r in verdict["reasons"])
    # a lag that grew and recovered still fails the bound it crossed
    recovered = dict(led.summary(), finality_lag_max=100,
                     finality_lag_last=2)
    assert not p.evaluate_gate(recovered, finality_lag_max_slots=64)["ok"]
    # empty horizon is never a pass
    assert not p.evaluate_gate(p.aggregate_summaries([]))["ok"]


# -- the two packages held to each other --------------------------------------


def _stream(jspec):
    """One epoch of blocks with attestations, built by the JAX helpers
    with BLS off, plus gossip: each block's attestations again as single
    gossip (one carrying BAD_SIGNATURE) and an attestation for a block
    that arrives later."""
    jp = _get("jax")
    state = jp.genesis.copy()
    _, blocks, post = jp.next_epoch_with_attestations(jspec, state, True,
                                                      False)
    late_state = post.copy()
    late = jp.build_empty_block_for_next_slot(jspec, late_state)
    late_signed = jp.state_transition_and_sign_block(jspec, late_state, late)
    early_att = jp.get_valid_attestation(
        jspec, late_state, slot=late.slot, signed=False,
        beacon_block_root=jspec.hash_tree_root(late))
    return blocks, late_signed, early_att


def test_one_gossip_stream_same_heads_in_both_packages():
    jp, tp = _get("jax"), _get("torch")
    blocks, late, early_att = _stream(jp.spec)
    bad_sig = jp.BAD_SIGNATURE
    outs = {}
    for p in (jp, tp):
        spec = p.spec
        move = lambda obj, typ: typ.decode_bytes(obj.encode_bytes())  # noqa
        head, _, svc, backend = _routed_service(spec, p.genesis)
        trail = []

        def gossip_batch(atts):
            p.bls.bls_active = True  # verdicts flow through the service
            try:
                return head.on_attestations(atts)
            finally:
                p.bls.bls_active = False  # blocks carry stub signatures

        try:
            for sb in blocks:
                sb = move(sb, spec.SignedBeaconBlock)
                _tick_to(spec, head, sb.message.slot)
                head.on_block(sb, process_attestations=False)
                gossip = [a.copy() for a in sb.message.body.attestations]
                if gossip and int(sb.message.slot) % 3 == 0:
                    gossip[0].signature = spec.BLSSignature(bad_sig)
                trail.append((bytes(head.get_head()), gossip_batch(gossip)))
            _tick_to(spec, head, late.message.slot + 1)
            trail.append(("early", gossip_batch(
                [move(early_att, spec.Attestation)])))
            head.on_block(move(late, spec.SignedBeaconBlock))
            trail.append((bytes(head.get_head()), head.deferred_count))
            snap = head.metrics.snapshot()
            snap.pop("apply_latency")
            gauges = p.profiling.stats_and_gauges()[1]
            chain_gauges = {k: v for k, v in gauges.items()
                            if k.startswith("chain.")}
        finally:
            svc.close(timeout=30)
        assert backend.calls > 0
        outs[p.name] = (trail, snap, chain_gauges)
    assert outs["torch"] == outs["jax"]
    trail, snap, _ = outs["torch"]
    assert snap["dropped"] >= 1 and snap["resolved"] == 1
    assert snap["applied"] > 0 and trail[-1][1] == 0


def test_chain_families_carry_the_jax_names():
    jp, tp = _get("jax"), _get("torch")
    assert tp.chain_metrics.GAUGE_LABELS == jp.chain_metrics.GAUGE_LABELS
    assert tp.GAUGE_LABELS == jp.GAUGE_LABELS
    assert tp.chain_metrics.APPLY_LABEL == jp.chain_metrics.APPLY_LABEL
    assert tuple(tp.CHAIN_STAGES) == tuple(jp.CHAIN_STAGES)
    names = (list(tp.chain_metrics.GAUGE_LABELS) + list(tp.GAUGE_LABELS)
             + ["merkle.native_levels", "merkle.cache_hits",
                "merkle.dirty_nodes", "merkle.fallbacks"])
    for name in names:
        assert tp.registry.GAUGES[name] == jp.registry.GAUGES[name], name
    for name in (tp.chain_metrics.APPLY_LABEL,
                 tp.latency.GOSSIP_TO_HEAD_LABEL):
        assert tp.registry.LATENCIES[name] == jp.registry.LATENCIES[name]
    for prefix in ("chain[", "health["):
        assert tp.registry.DYNAMIC_PREFIXES[prefix] == \
            jp.registry.DYNAMIC_PREFIXES[prefix]
    assert set(tp.CHAIN_STAGES) | {"merkle_root"} <= set(tp.latency.STAGES)
    assert tp.registry.node_label("chain.blocks", "n1") == "chain[n1].blocks"


def test_gossip_to_head_lands_in_the_port_histogram():
    """Items with a birth record report their gossip->head latency into
    ``latency.gossip_to_head`` at the head update, through the port's
    service, and the family renders on the port's Prometheus surface."""
    tp = _get("torch")
    spec = tp.spec
    head, state, svc, _ = _routed_service(spec, tp.genesis)
    try:
        atts = [tp.get_valid_attestation(spec, state.copy(), slot=state.slot,
                                         index=i, signed=False)
                for i in range(2)]
        _tick_to(spec, head, state.slot + 1)
        tp.bls.bls_active = True
        births = [tp.latency.birth() for _ in atts]
        summary = head.on_attestations(atts, births=births)
        assert summary["applied"] > 0
        with pytest.raises(ValueError, match="births misaligned"):
            head.on_attestations(atts, births=births[:1])
    finally:
        svc.close(timeout=30)
    hist = tp.profiling.latency_histograms()[tp.latency.GOSSIP_TO_HEAD_LABEL]
    assert hist.count == len(atts)
    for stage in tp.CHAIN_STAGES:
        assert tp.latency.stage_label(stage) in tp.latency.snapshot()
    text = tp.registry.render_prometheus()
    assert "consensus_specs_tpu_latency_gossip_to_head" in text
    assert "consensus_specs_tpu_chain_apply_batch" in text
