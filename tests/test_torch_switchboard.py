"""The port's switchboard (consensus_specs_tpu_torch/utils/bls.py) against
the JAX package's (consensus_specs_tpu/utils/bls.py), name for name, on
the same inputs: the constants, the point helpers, the pairings and their
``bls_active``-off answers, and what both packages do with an item whose
host decode raises something other than ValueError.
"""
import numpy as np
import pytest

from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu.utils import bls12_381 as JO
from consensus_specs_tpu_torch.utils import bls as tbls
from consensus_specs_tpu_torch.utils import bls12_381 as TO
from tests.torch_threads import one_thread

one_thread()

RNG = np.random.default_rng(20261017)
SKS = [int(x) for x in RNG.integers(1, 1 << 62, size=3)]
MSG = RNG.bytes(32)


@pytest.fixture(autouse=True)
def _oracle_switchboards():
    """Both switchboards on the CPU oracle with BLS on; flags restored."""
    was = (jbls.bls_active, tbls.bls_active, tbls._backend)
    jbls.bls_active = tbls.bls_active = True
    tbls.use_py_ecc()
    yield
    jbls.bls_active, tbls.bls_active, tbls._backend = was


def test_constants_match_reference():
    assert tbls.G2_POINT_AT_INFINITY == jbls.G2_POINT_AT_INFINITY
    assert tbls.G2_POINT_AT_INFINITY == b"\xc0" + b"\x00" * 95
    assert tbls.STUB_COORDINATES == jbls.STUB_COORDINATES
    assert tbls.STUB_SIGNATURE == jbls.STUB_SIGNATURE
    assert tbls.STUB_PUBKEY == jbls.STUB_PUBKEY


def _signature_cases():
    sig = jbls.Sign(SKS[0], MSG)
    flipped = bytes([sig[0] ^ 0x20]) + sig[1:]  # the other y
    return [
        ("valid", sig),
        ("flipped_sign", flipped),
        ("infinity", jbls.G2_POINT_AT_INFINITY),
        ("short", sig[:95]),
        ("uncompressed", bytes([sig[0] & 0x7F]) + sig[1:]),
        ("x_out_of_range", b"\x9f" + b"\xff" * 95),
        ("bad_infinity", b"\xc0" + b"\x00" * 94 + b"\x01"),
    ]


@pytest.mark.parametrize("name,data", _signature_cases(),
                         ids=[c[0] for c in _signature_cases()])
def test_signature_to_G2_matches_reference(name, data):
    try:
        want = jbls.signature_to_G2(data)
    except Exception as e:  # noqa: BLE001 - the reference's own raise
        with pytest.raises(type(e)):
            tbls.signature_to_G2(data)
        return
    got = tbls.signature_to_G2(data)
    assert got == want
    if name == "infinity":
        assert got is None
    elif name == "valid":
        assert got is not None and all(isinstance(c, int)
                                       for xy in got for c in xy)


@pytest.mark.parametrize("data", [
    jbls.SkToPk(SKS[1]),
    b"\xc0" + b"\x00" * 47,
    jbls.SkToPk(SKS[2])[:47],
    b"\x9f" + b"\xff" * 47,
], ids=["valid", "infinity", "short", "x_out_of_range"])
def test_pubkey_to_G1_matches_reference(data):
    try:
        want = jbls.pubkey_to_G1(data)
    except Exception as e:  # noqa: BLE001
        with pytest.raises(type(e)):
            tbls.pubkey_to_G1(data)
        return
    got = tbls.pubkey_to_G1(data)
    if want is None:
        assert got is None
    else:
        assert (got[0].n, got[1].n) == (want[0].n, want[1].n)


def _pairs(oracle, sk):
    p = oracle.ec_to_affine(oracle.ec_mul(oracle.G1_GEN, sk))
    q = oracle.ec_to_affine(oracle.G2_GEN)
    neg_p = oracle.ec_to_affine(oracle.ec_neg(oracle.ec_from_affine(p)))
    return p, q, neg_p


def test_pairing_check_matches_reference():
    tp, tq, tneg = _pairs(TO, SKS[0])
    jp, jq, jneg = _pairs(JO, SKS[0])
    assert tbls.pairing_check([(tp, tq), (tneg, tq)]) is True
    assert jbls.pairing_check([(jp, jq), (jneg, jq)]) is True
    assert tbls.pairing_check([(tp, tq), (tp, tq)]) is False
    assert jbls.pairing_check([(jp, jq), (jp, jq)]) is False


def _flat(gt):
    return [c for f6 in (gt.c0, gt.c1) for f2 in (f6.c0, f6.c1, f6.c2)
            for c in (f2.c0, f2.c1)]


def test_pairing_matches_reference_over_bytes_and_points():
    pk = jbls.SkToPk(SKS[1])
    sig = jbls.Sign(SKS[1], MSG)
    want = jbls.Pairing(pk, sig)
    got = tbls.Pairing(pk, sig)
    assert _flat(got) == _flat(want)
    # the same pairing over affine and projective points
    p_aff = TO.g1_from_bytes(pk)
    q_aff = TO.g2_from_bytes(sig)
    assert tbls.Pairing(p_aff, q_aff) == got
    assert tbls.Pairing(TO.ec_from_affine(p_aff),
                        TO.ec_from_affine(q_aff)) == got
    # e(sk*G1, H) == e(G1, sk*H): the sharding draft's equality of pairings
    h = TO.ec_to_affine(TO.hash_to_g2(MSG, tbls.DST))
    assert tbls.Pairing(TO.ec_to_affine(TO.G1_GEN), sig) == tbls.Pairing(pk, h)
    assert _flat(tbls.Pairing(pk, h)) == _flat(jbls.Pairing(
        pk, JO.ec_to_affine(JO.hash_to_g2(MSG, jbls.DST))))
    assert tbls.Pairing(pk, sig) != tbls.Pairing(jbls.SkToPk(SKS[2]), sig)


def test_stub_answers_with_bls_off():
    jbls.bls_active = tbls.bls_active = False
    p = TO.ec_to_affine(TO.G1_GEN)
    q = TO.ec_to_affine(TO.G2_GEN)
    assert tbls.pairing_check([(p, q)]) is True
    assert jbls.pairing_check([(p, q)]) is True
    assert tbls.Pairing(p, q) is None
    assert jbls.Pairing(p, q) is None
    # the point helpers stay oracle functions whatever the flag says
    sig = b"\xc0" + b"\x00" * 95
    assert tbls.signature_to_G2(sig) is None is jbls.signature_to_G2(sig)


# an item whose host decode raises neither ValueError nor TypeError: both
# packages convert every input with bytes() before the per-item loop, so
# the batch call raises the same error on both, and the switchboards'
# verify functions answer False
_UNDECODABLE = {
    "int_signature": ("sig", 2 ** 64, OverflowError),
    "int_pubkey": ("pk", 2 ** 64, OverflowError),
    "none_signature": ("sig", None, TypeError),
    "byte_out_of_range": ("sig", [300], ValueError),
}


@pytest.mark.parametrize("case", sorted(_UNDECODABLE))
def test_undecodable_item_same_on_both_packages(case, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    from consensus_specs_tpu.ops import bls_backend as jback
    from consensus_specs_tpu_torch.ops import bls_backend as tback

    where, value, err = _UNDECODABLE[case]
    pk = jbls.SkToPk(SKS[0])
    sig = jbls.Sign(SKS[0], MSG)
    pks = [[value if where == "pk" else pk], [pk]]
    sigs = [value if where == "sig" else sig, sig]
    items = [("fast_aggregate", p, MSG, s) for p, s in zip(pks, sigs)]
    for call in (
        lambda: jback.batch_fast_aggregate_verify(pks, [MSG, MSG], sigs),
        lambda: tback.batch_fast_aggregate_verify(pks, [MSG, MSG], sigs,
                                                  device="cpu"),
        lambda: jback.batch_verify_rlc(items),
        lambda: tback.batch_verify_rlc(items, device="cpu"),
    ):
        with pytest.raises(err):
            call()
    assert jbls.FastAggregateVerify(pks[0], MSG, sigs[0]) is False
    assert tbls.FastAggregateVerify(pks[0], MSG, sigs[0]) is False
    assert jbls.Verify(pks[0][0], MSG, sigs[0]) is False
    assert tbls.Verify(pks[0][0], MSG, sigs[0]) is False
