"""The port's mainnet-scale plane (consensus_specs_tpu_torch/scale/) and
the epoch's check set (consensus_specs_tpu_torch/bench/epoch_replay.py)
against the JAX package's, on the CPU.

The registry's shuffling and committees must be bit-identical (the
shuffle alone up to 1,048,576 validators), its committee items equal
field for field (derived in one process or in a spawn pool), the pubkey
plane's limbs equal, and the slot verification at a tiny committee size
(``device="cpu"``, the plain VM steps) must give the JAX plane's
verdicts, combines, bisections and localized bad committee.
"""
import hashlib

import numpy as np
import pytest

from consensus_specs_tpu.scale import hierarchy as jhier
from consensus_specs_tpu.scale import pubkeys as jpk
from consensus_specs_tpu.scale import registry as jreg
from consensus_specs_tpu_torch.scale import hierarchy as thier
from consensus_specs_tpu_torch.scale import pubkeys as tpk
from consensus_specs_tpu_torch.scale import registry as treg
from consensus_specs_tpu_torch.utils.keygen import KeyPool
from tests.torch_threads import one_thread

one_thread()

SEED = hashlib.sha256(b"torch-scale-shuffle").digest()


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    """The JAX side as its own tests run it: interpreter, Pallas off."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")


@pytest.mark.parametrize("n,rounds", [
    (1, 90), (2, 90), (3, 90), (97, 10), (257, 90), (4096, 90),
    (1 << 20, 90),
])
def test_shuffle_batch_bit_identical(n, rounds):
    got = treg.shuffle_batch(n, SEED, rounds)
    want = jreg.shuffle_batch(n, SEED, rounds)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,slot,kwargs", [
    (131, 5, {}),
    (8192, 0, {}),
    (8192, 33, {}),
    (64, 3, dict(slots_per_epoch=8, target_size=2, shuffle_rounds=4)),
    (300, 7, dict(target_size=4, shuffle_rounds=12)),
])
def test_registry_committees_bit_identical(n, slot, kwargs):
    t = treg.Registry(n, seed=11, **kwargs)
    j = jreg.Registry(n, seed=11, **kwargs)
    assert t.committees_per_slot() == j.committees_per_slot()
    assert t.attester_seed(slot // t.slots_per_epoch) == j.attester_seed(
        slot // j.slots_per_epoch)
    got, want = t.committees_at_slot(slot), j.committees_at_slot(slot)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for i in (0, n // 2, n - 1):
        assert t.secret_key(i) == j.secret_key(i)
    assert t.attestation_message(slot, 0) == j.attestation_message(slot, 0)


def test_committee_counts_match_reference():
    for n in (1, 4096, 8192, 300_000, 1 << 20, 1 << 22):
        assert treg.committee_count_per_slot(n) == \
            jreg.committee_count_per_slot(n)
        assert treg.attesters_per_slot(n) == jreg.attesters_per_slot(n)
    assert treg.committee_count_per_slot(1 << 20) == 64


def _reg_pair():
    kw = dict(seed=13, slots_per_epoch=8, target_size=2, shuffle_rounds=4)
    return treg.Registry(64, **kw), jreg.Registry(64, **kw)


def test_committee_items_equal_field_for_field():
    t, j = _reg_pair()
    want = jhier.committee_items(j, slot=3)
    assert thier.committee_items(t, slot=3) == want
    censored = jhier.committee_items(j, slot=3, participation=0.5)
    assert thier.committee_items(t, slot=3, participation=0.5) == censored
    assert [len(it[1]) for it in censored] != [len(it[1]) for it in want]


def test_key_pool_gives_the_switchboards_bytes():
    """A spawn pool of 2 (more items than one task carries, so the pool
    path runs) gives what the JAX switchboard gives, in order."""
    from consensus_specs_tpu.utils import bls as jbls

    t, j = _reg_pair()
    sks = [t.secret_key(i) for i in range(64)] + list(range(1, 67))
    pairs = [((i << 40) + 7, bytes([i % 256]) * 32) for i in range(66)]
    with KeyPool(2) as pool:
        assert pool.sk_to_pk(sks) == [jbls.SkToPk(sk) for sk in sks]
        assert pool.sign(pairs) == [jbls.Sign(sk, m) for sk, m in pairs]
        assert thier.committee_items(t, slot=3, pool=pool) == \
            jhier.committee_items(j, slot=3)
        with pytest.raises(ValueError):
            pool.sk_to_pk([0] * 70)


def test_epoch_check_set_matches_reference():
    from consensus_specs_tpu.bench import epoch_replay as jepoch
    from consensus_specs_tpu_torch.bench import epoch_replay as tepoch

    shape = (2, 2, 3, 4, 6)
    jcol = jepoch.build_epoch_checks(*shape)
    tcol = tepoch.build_epoch_checks(*shape)
    assert [(c.kind, c.pubkeys, c.messages, c.signature)
            for c in tcol.checks] == [
        (c.kind, c.pubkeys, c.messages, c.signature) for c in jcol.checks]
    assert len(tcol.checks) == 2 * (2 + 1 + 1)
    assert tepoch.epoch_signatures(32, 64, 146, 512) == 315_424


def test_pubkey_plane_limbs_match_reference():
    from consensus_specs_tpu.utils import bls as jbls

    pks = [jbls.SkToPk((200 + i) << 4) for i in range(4)]
    bad = b"\xa0" + b"\xff" * 47
    inf = b"\xc0" + b"\x00" * 47
    tplane = tpk.PubkeyPlane(budget_bytes=1 << 30, mirror_backend=False,
                             device="cpu")
    jplane = jpk.PubkeyPlane(budget_bytes=1 << 30, mirror_backend=False)
    assert tplane.warm(pks + [bad, inf]) == jplane.warm(pks + [bad, inf])
    assert tplane.rejected == jplane.rejected == 2
    assert len(tplane) == len(jplane) == 4
    for pk in pks:
        for got, want in zip(tplane.get(pk), jplane.get(pk)):
            assert np.array_equal(np.asarray(got), np.asarray(want))
    assert tplane.bytes == jplane.bytes
    assert tplane.hit_rate() == jplane.hit_rate()


def test_pubkey_plane_mirrors_into_the_ports_backend_cache():
    from consensus_specs_tpu_torch.ops import bls_backend
    from consensus_specs_tpu_torch.utils import bls

    pks = [bls.SkToPk((300 + i) << 4) for i in range(3)]
    for pk in pks:
        bls_backend._PK_CACHE.pop(pk, None)
    probe = tpk.PubkeyPlane(budget_bytes=1 << 30, mirror_backend=False,
                            device="cpu")
    probe.warm(pks[:1])
    plane = tpk.PubkeyPlane(budget_bytes=2 * probe.bytes, device="cpu")
    plane.warm(pks)
    assert plane.evictions == 1
    assert pks[0] not in bls_backend._PK_CACHE
    assert pks[1] in bls_backend._PK_CACHE and pks[2] in bls_backend._PK_CACHE
    for pk in pks:
        bls_backend._PK_CACHE.pop(pk, None)


def _accounting(report):
    return (report.verdicts.tolist(), report.combines, report.bisections,
            report.bad_committees, report.committees, report.attestations)


def test_verify_slot_matches_reference_plane():
    """The planted slot (committee 2 of 4 corrupted) and the all-valid
    slot: the same verdicts, combines, bisections and localized bad
    committee as the JAX plane; the flat path agrees."""
    t, j = _reg_pair()
    items = thier.committee_items(t, slot=3)
    bad_ci = 2
    items[bad_ci] = thier.corrupt_item(items[bad_ci])
    assert items[bad_ci] == jhier.corrupt_item(
        jhier.committee_items(j, slot=3)[bad_ci])

    tplane = tpk.PubkeyPlane(budget_bytes=1 << 30, mirror_backend=True,
                             device="cpu")
    got = thier.verify_slot(items, slot=3, plane=tplane, device="cpu")
    want = jhier.verify_slot(items, slot=3)
    assert _accounting(got) == _accounting(want)
    assert got.bad_committees == [bad_ci]
    assert (got.combines, got.bisections) == (3, 2)
    assert got.pubkey_misses > 0 and got.pubkey_hits == 0

    flat = thier.verify_slot_flat(items, device="cpu")
    assert flat.tolist() == got.verdicts.tolist()
    assert flat.tolist() == jhier.verify_slot_flat(items).tolist()
    assert thier.verify_slot_oracle(items[bad_ci:]).tolist() == [False, True]

    good = thier.committee_items(t, slot=3)
    got2 = thier.verify_slot(good, slot=3, plane=tplane, device="cpu")
    want2 = jhier.verify_slot(good, slot=3)
    assert _accounting(got2) == _accounting(want2)
    assert got2.all_valid and got2.final_exps_per_slot == 1.0
    assert got2.pubkey_hits > 0 and got2.pubkey_misses == 0


# -- committee-affinity routing (scale/routing.py) and the smoke's phase 4 ---


class _RingRouter:
    """The piece of a FleetRouter that CommitteeFleet's assignment reads:
    ``route_label`` over one package's consistent-hash ring."""

    def __init__(self, ring_cls, labels):
        self._ring = ring_cls()
        for label in labels:
            self._ring.add(label)

    def route_label(self, key):
        return self._ring.route(key)


@pytest.mark.parametrize("labels", [("w0", "w1"), ("w0", "w1", "w2")])
def test_committee_affinity_assignment_matches_reference(labels):
    from consensus_specs_tpu.scale import routing as jrouting
    from consensus_specs_tpu.serve.fleet import HashRing as JRing
    from consensus_specs_tpu_torch.scale import routing as trouting
    from consensus_specs_tpu_torch.serve.fleet import HashRing as TRing

    for ci in (0, 1, 63, 12345):
        assert trouting.committee_key(ci) == jrouting.committee_key(ci)
    got = trouting.CommitteeFleet(router=_RingRouter(TRing, labels))
    want = jrouting.CommitteeFleet(router=_RingRouter(JRing, labels))
    assign = got.assignment(range(64))
    assert assign == want.assignment(range(64))
    assert set(assign.values()) == set(labels)
    got.close()  # a borrowed router is not closed


def test_smoke_phase_4_affinity_through_a_verdict_fleet():
    """The port's scale/smoke.py phase 4 on the CPU: the slot's committees
    through a real 2-worker verdict fleet twice, every verdict True, the
    assignment stable and the reference's, 0 affinity moves."""
    from consensus_specs_tpu.scale import routing as jrouting
    from consensus_specs_tpu.serve.fleet import HashRing as JRing
    from consensus_specs_tpu_torch.scale import smoke

    out = smoke.run_affinity(16, device="cpu")
    want = jrouting.CommitteeFleet(
        router=_RingRouter(JRing, ("w0", "w1"))).assignment(range(16))
    assert out["assignment"] == want
    assert out["committees_routed"] == 16
    assert out["workers_covered"] == 2
