"""on_tick handler unit tests (original; scenario space of the reference's
phase0/unittests/fork_choice/test_on_tick.py; spec
specs/phase0/fork-choice.md:320-337)."""
from ....context import spec_state_test, with_all_phases
from ....helpers.fork_choice import get_genesis_forkchoice_store, slot_time


def _tick(spec, store, time):
    spec.on_tick(store, spec.uint64(int(time)))
    assert store.time == time


@with_all_phases
@spec_state_test
def test_basic_tick(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    _tick(spec, store, store.time + 1)


@with_all_phases
@spec_state_test
def test_tick_to_next_slot(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    _tick(spec, store, slot_time(spec, store, 1))
    assert spec.get_current_slot(store) == 1


@with_all_phases
@spec_state_test
def test_tick_mid_epoch_no_checkpoint_promotion(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    pre_justified = store.justified_checkpoint.copy()
    # pretend a better checkpoint was seen (same chain: the anchor)
    store.best_justified_checkpoint = spec.Checkpoint(
        epoch=pre_justified.epoch + 1, root=pre_justified.root
    )
    # a tick within the epoch must NOT promote
    _tick(spec, store, slot_time(spec, store, 2))
    assert store.justified_checkpoint == pre_justified


@with_all_phases
@spec_state_test
def test_tick_epoch_boundary_promotes_best_justified(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    pre_justified = store.justified_checkpoint.copy()
    store.best_justified_checkpoint = spec.Checkpoint(
        epoch=pre_justified.epoch + 1, root=pre_justified.root
    )
    _tick(spec, store, slot_time(spec, store, spec.SLOTS_PER_EPOCH))
    assert store.justified_checkpoint == store.best_justified_checkpoint


@with_all_phases
@spec_state_test
def test_tick_epoch_boundary_skipped_when_equal(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    pre_justified = store.justified_checkpoint.copy()
    # best == justified: nothing to promote
    _tick(spec, store, slot_time(spec, store, spec.SLOTS_PER_EPOCH))
    assert store.justified_checkpoint == pre_justified


@with_all_phases
@spec_state_test
def test_tick_same_time_twice(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    t = slot_time(spec, store, spec.SLOTS_PER_EPOCH)
    _tick(spec, store, t)
    justified_after_first = store.justified_checkpoint.copy()
    # re-delivering the same boundary time is a no-op (no new slot)
    _tick(spec, store, t)
    assert store.justified_checkpoint == justified_after_first


@with_all_phases
@spec_state_test
def test_tick_multiple_epochs_at_once(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    pre_justified = store.justified_checkpoint.copy()
    store.best_justified_checkpoint = spec.Checkpoint(
        epoch=pre_justified.epoch + 1, root=pre_justified.root
    )
    # jumping several epochs in one tick still lands on an epoch start
    _tick(spec, store, slot_time(spec, store, 3 * int(spec.SLOTS_PER_EPOCH)))
    assert store.justified_checkpoint == store.best_justified_checkpoint
