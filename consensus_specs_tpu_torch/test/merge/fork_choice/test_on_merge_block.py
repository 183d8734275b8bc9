"""on_block terminal-PoW validation at the merge-transition block
(original; reference specs/merge/fork-choice.md:93-131 and the reference's
merge/fork_choice/test_on_merge_block.py scenario space)."""
from ...context import MERGE, spec_state_test, with_phases
from ...helpers.block import build_empty_block_for_next_slot, sign_block
from ...helpers.execution_payload import (
    build_empty_execution_payload,
    build_state_with_incomplete_transition,
)
from ...helpers.fork_choice import (
    get_genesis_forkchoice_store_and_block,
    run_on_block,
    tick_to_slot,
)

# the last case's store/block, for post-drive assertions in yielding tests
_LAST_CASE = {}


class _PowChain:
    """Monkeypatch context: spec.get_pow_block serves from a fixed chain
    (the reference's pow-block patch pattern; its stub, like ours, is
    injected at build time — setup.py:509-514)."""

    def __init__(self, spec, blocks):
        self.spec = spec
        self.chain = {bytes(b.block_hash): b for b in blocks}

    def __enter__(self):
        self._old = self.spec.get_pow_block
        chain = self.chain
        self.spec.get_pow_block = lambda block_hash: chain.get(bytes(block_hash))
        return self

    def __exit__(self, *exc):
        self.spec.get_pow_block = self._old
        return False


def _pow_block(spec, block_hash, parent_hash, td):
    return spec.PowBlock(
        block_hash=spec.Hash32(block_hash),
        parent_hash=spec.Hash32(parent_hash),
        total_difficulty=spec.uint256(int(td)),
        difficulty=spec.uint256(1),
    )


def _terminal_pow_chain(spec, crossed=True, parent_crossed=False):
    ttd = int(spec.config.TERMINAL_TOTAL_DIFFICULTY)
    parent = _pow_block(
        spec, b'\x41' * 32, b'\x40' * 32,
        ttd if parent_crossed else max(0, ttd - 1),
    )
    head = _pow_block(
        spec, b'\x42' * 32, parent.block_hash,
        ttd if crossed else max(0, ttd - 1),
    )
    return parent, head


def _merge_block_on_pow_head(spec, state, pow_head):
    block = build_empty_block_for_next_slot(spec, state)
    tmp = state.copy()
    spec.process_slots(tmp, block.slot)
    payload = build_empty_execution_payload(spec, tmp)
    payload.parent_hash = pow_head.block_hash
    payload.block_hash = spec.Hash32(
        spec.hash(payload.hash_tree_root() + b"FAKE RLP HASH")
    )
    block.body.execution_payload = payload
    return block


def _run_merge_block_case(spec, state, pow_blocks, valid=True, pow_head=None):
    """Drives the handler AND emits a fork_choice-format vector case
    (anchor_state/anchor_block/steps, tests/formats/fork_choice)."""
    build_state_with_incomplete_transition(spec, state)
    store, anchor = get_genesis_forkchoice_store_and_block(spec, state)
    yield 'anchor_state', state
    yield 'anchor_block', anchor
    test_steps = []
    block = _merge_block_on_pow_head(spec, state, pow_head)
    tick_to_slot(spec, store, block.slot, test_steps)
    with _PowChain(spec, pow_blocks):
        # compute the post-state root with the pow chain visible, then drive
        # the handler
        post = state.copy()
        spec.process_slots(post, block.slot)
        spec.process_block(post, block)
        block.state_root = spec.hash_tree_root(post)
        signed = sign_block(spec, state, block)
        run_on_block(spec, store, signed, valid=valid)
        test_steps.append({'block': f'on_merge_block_{int(block.slot)}', 'valid': valid})
    yield 'steps', 'data', test_steps
    _LAST_CASE.clear()
    _LAST_CASE.update(store=store, block=block)


@with_phases([MERGE])
@spec_state_test
def test_merge_block_terminal_crossing_accepted(spec, state):
    parent, head = _terminal_pow_chain(spec, crossed=True, parent_crossed=False)
    yield from _run_merge_block_case(
        spec, state, [parent, head], valid=True, pow_head=head,
    )
    assert spec.hash_tree_root(_LAST_CASE['block']) in _LAST_CASE['store'].blocks


@with_phases([MERGE])
@spec_state_test
def test_merge_block_pow_block_missing(spec, state):
    # the payload's parent is not in the PoW chain view at all
    parent, head = _terminal_pow_chain(spec, crossed=True)
    yield from _run_merge_block_case(spec, state, [parent], valid=False, pow_head=head)


@with_phases([MERGE])
@spec_state_test
def test_merge_block_pow_parent_missing(spec, state):
    parent, head = _terminal_pow_chain(spec, crossed=True)
    yield from _run_merge_block_case(spec, state, [head], valid=False, pow_head=head)


@with_phases([MERGE])
@spec_state_test
def test_merge_block_ttd_not_reached(spec, state):
    parent, head = _terminal_pow_chain(spec, crossed=False)
    yield from _run_merge_block_case(spec, state, [parent, head], valid=False, pow_head=head)


@with_phases([MERGE])
@spec_state_test
def test_merge_block_parent_already_crossed(spec, state):
    # not the crossing block: the parent already met the TTD
    parent, head = _terminal_pow_chain(spec, crossed=True, parent_crossed=True)
    yield from _run_merge_block_case(spec, state, [parent, head], valid=False, pow_head=head)
