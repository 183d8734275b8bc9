"""The port's batched input codec (consensus_specs_tpu_torch/ops/codec.py)
against the JAX package's codec and the per-item oracle, on the CPU, on
both placements: the raw-int host path (the CPU default) and the tensor
path (CONSENSUS_SPECS_TPU_CODEC_DEVICE=1: the field functions on the plain
Montgomery product, the subgroup and hash-finish programs on the plain
VM steps). Limb payloads must be equal byte for byte, failures ValueError
for ValueError with the same message, on valid points, invalid encodings,
points outside the subgroup (torsion included) and infinity.

The JAX codec runs its host path here (its device path is --run-slow
only); the oracle is the per-item compute functions of the port's
bls_backend.
"""
import functools
import os

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import codec as jcodec  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend as tbls  # noqa: E402
from consensus_specs_tpu_torch.ops import codec  # noqa: E402
from consensus_specs_tpu_torch.utils import bls12_381 as O  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

DST = tbls.DST
ENV = "CONSENSUS_SPECS_TPU_CODEC_DEVICE"


def _norm(v):
    """Codec and per-item results on one footing: ValueErrors (raised or
    returned) by message, limb payloads by bytes."""
    if isinstance(v, ValueError):
        return ("err", str(v))
    if v is None:
        return ("inf",)
    if isinstance(v, tuple):
        return ("ok", tuple(np.asarray(x).tobytes() for x in v))
    return ("ok", np.asarray(v).tobytes())


def _ref(fn, blob):
    try:
        return _norm(fn(blob))
    except ValueError as e:
        return ("err", str(e))


def _scalar(rng):
    return int.from_bytes(rng.bytes(32), "big") % (O.R - 1) + 1


def _rand_g1_affine(rng):
    while True:
        x = int.from_bytes(rng.bytes(48), "big") % O.P
        y = O.fq_sqrt((x * x % O.P * x + 4) % O.P)
        if y is not None:
            return (O.Fq(x), O.Fq(y))


def _rand_g2_affine(rng):
    while True:
        x = O.Fq2(int.from_bytes(rng.bytes(48), "big") % O.P,
                  int.from_bytes(rng.bytes(48), "big") % O.P)
        y = (x * x * x + O.B_G2).sqrt()
        if y is not None:
            return (x, y)


@functools.lru_cache(maxsize=None)
def _pool_g1():
    """16 blobs: members, a random curve point, a cofactor-torsion point,
    infinity (valid and corrupted), x off the curve, x >= p, and the
    structural rejections."""
    rng = np.random.default_rng(4101)
    torsion = O.ec_mul(O.ec_from_affine(_rand_g1_affine(rng)), O.R)
    inf = bytes([O.FLAG_COMPRESSED | O.FLAG_INFINITY]) + b"\x00" * 47
    return [
        O.g1_to_bytes(O.ec_mul(O.G1_GEN, _scalar(rng))),
        O.g1_to_bytes(O.ec_from_affine(_rand_g1_affine(rng))),
        O.g1_to_bytes(torsion),
        O.g1_to_bytes(O.ec_mul(O.G1_GEN, _scalar(rng))),
        inf,
        inf[:1] + b"\x01" + inf[2:],
        bytes([0x80]) + b"\x00" * 46 + b"\x05",
        bytes([0x9F]) + b"\xff" * 47,
        b"\x00" * 48,
        b"\x12" * 48,
        b"\xc0" + b"\x00" * 40,
        O.g1_to_bytes(O.G1_GEN)[:47],
        O.g1_to_bytes(O.ec_neg(O.ec_mul(O.G1_GEN, _scalar(rng)))),
        O.g1_to_bytes(O.G1_GEN),
        O.g1_to_bytes(O.ec_from_affine(_rand_g1_affine(rng))),
        O.g1_to_bytes(O.ec_mul(O.G1_GEN, 7)),
    ]


@functools.lru_cache(maxsize=None)
def _pool_g2():
    rng = np.random.default_rng(4102)
    torsion = O.ec_mul(O.ec_from_affine(_rand_g2_affine(rng)), O.R)
    inf = bytes([O.FLAG_COMPRESSED | O.FLAG_INFINITY]) + b"\x00" * 95
    return [
        O.g2_to_bytes(O.ec_mul(O.G2_GEN, _scalar(rng))),
        O.g2_to_bytes(_rand_g2_affine(rng)),
        O.g2_to_bytes(torsion),
        O.g2_to_bytes(O.ec_mul(O.G2_GEN, _scalar(rng))),
        inf,
        inf[:5] + b"\x01" + inf[6:],
        bytes([0x80]) + b"\x00" * 94 + b"\x07",
        bytes([0x9F]) + b"\xff" * 95,
        b"\x00" * 96,
        b"\x34" * 96,
        b"\xc0" + b"\x01" * 95,
        O.g2_to_bytes(O.G2_GEN)[:95],
        O.g2_to_bytes(O.ec_neg(O.ec_mul(O.G2_GEN, _scalar(rng)))),
        O.g2_to_bytes(O.G2_GEN),
    ]


def _pool_msgs():
    rng = np.random.default_rng(4103)
    return [b"", b"\x00", b"q" * 130, rng.bytes(32), rng.bytes(8),
            rng.bytes(64)]


POOLS = {
    "pubkey": (_pool_g1, tbls._pubkey_limbs_compute,
               lambda xs, **kw: codec.pubkey_limbs_batch(xs, **kw),
               jcodec.pubkey_limbs_batch),
    "signature": (_pool_g2, tbls._signature_limbs_compute,
                  lambda xs, **kw: codec.signature_limbs_batch(xs, **kw),
                  jcodec.signature_limbs_batch),
    "message": (_pool_msgs, tbls._message_limbs_compute,
                lambda xs, **kw: codec.message_limbs_batch(xs, DST, **kw),
                lambda xs: jcodec.message_limbs_batch(xs, DST)),
}


@functools.lru_cache(maxsize=None)
def _references(kind):
    """(per-item oracle, JAX codec host path) results over the pool."""
    pool_fn, oracle, _, jax_batch = POOLS[kind]
    pool = pool_fn()
    old = os.environ.get(ENV)
    os.environ[ENV] = "0"
    try:
        jax_res = [_norm(v) for v in jax_batch(pool)]
    finally:
        if old is None:
            del os.environ[ENV]
        else:
            os.environ[ENV] = old
    return [_ref(oracle, b) for b in pool], jax_res


@pytest.mark.parametrize("placement", ["host", "tensor"])
@pytest.mark.parametrize("kind", sorted(POOLS))
def test_batch_codec_matches_jax_codec_and_oracle(kind, placement,
                                                  monkeypatch):
    oracle, jax_res = _references(kind)
    assert oracle == jax_res
    monkeypatch.setenv(ENV, "0" if placement == "host" else "1")
    pool = POOLS[kind][0]()
    got = [_norm(v) for v in POOLS[kind][2](pool, device="cpu")]
    assert got == oracle
    if kind != "message":
        assert {r[0] for r in got} == {"ok", "err"}
        assert any(r == ("err", f"{kind} not in "
                         f"G{1 if kind == 'pubkey' else 2} subgroup")
                   for r in got)


@pytest.mark.parametrize("kind", ["pubkey", "signature"])
def test_single_item_tensor_path(kind, monkeypatch):
    """n = 1: one row, fold 1, no padding."""
    monkeypatch.setenv(ENV, "1")
    oracle, _ = _references(kind)
    pool = POOLS[kind][0]()
    got = _norm(POOLS[kind][2](pool[:1], device="cpu")[0])
    assert got == oracle[0]


def test_decompress_infinity_is_none():
    inf1 = bytes([O.FLAG_COMPRESSED | O.FLAG_INFINITY]) + b"\x00" * 47
    inf2 = bytes([O.FLAG_COMPRESSED | O.FLAG_INFINITY]) + b"\x00" * 95
    assert codec.decompress_g1_batch([inf1], device="cpu") == [None]
    assert codec.decompress_g2_batch([inf2], device="cpu") == [None]
    assert _norm(codec.pubkey_limbs_batch([inf1], device="cpu")[0]) == (
        "err", "pubkey is the point at infinity")
    assert _norm(codec.signature_limbs_batch([inf2], device="cpu")[0]) == (
        "err", "signature is the point at infinity")


def test_expand_message_xmd_batch_matches_oracle():
    msgs = [b"", b"abc", b"q" * 200, b"\x00" * 31]
    for lib in (32, 64, 100, 256):
        got = codec.expand_message_xmd_batch(msgs, DST, lib)
        assert got == [O.expand_message_xmd(m, DST, lib) for m in msgs]
        assert got == jcodec.expand_message_xmd_batch(msgs, DST, lib)
    with pytest.raises(ValueError, match="DST too long"):
        codec.expand_message_xmd_batch(msgs, b"x" * 256, 32)
    with pytest.raises(ValueError, match="len_in_bytes too large"):
        codec.expand_message_xmd_batch(msgs, DST, 256 * 32)
    assert codec.expand_message_xmd_batch([], DST, 32) == []


def test_hash_to_field_matches_reference():
    msgs = _pool_msgs()
    got = codec.hash_to_field_fq2_batch(msgs, 2, DST)
    assert np.array_equal(got, jcodec.hash_to_field_fq2_batch(msgs, 2, DST))


def test_int_batch_inverse_matches_fermat():
    rng = np.random.default_rng(4104)
    vals = [0, 1, O.P - 1] + [int.from_bytes(rng.bytes(48), "big") % O.P
                              for _ in range(13)]
    got = codec.int_batch_inverse(vals)
    assert got == jcodec.int_batch_inverse(vals)
    for v, iv in zip(vals, got):
        assert iv == (pow(v, O.P - 2, O.P) if v else 0)


def test_glv_beta_eigenvalue_against_generator():
    """The host G1 membership test hinges on phi(P) == [-z^2]P with
    _BETA_G1 the matching cube root."""
    z = codec._X_ABS
    g = O.ec_to_affine(O.G1_GEN)
    phi = (codec._BETA_G1 * g[0].n % O.P, g[1].n)
    q = O.ec_to_affine(O.ec_neg(O.ec_mul(O.G1_GEN, z * z)))
    assert phi == (q[0].n, q[1].n)
    assert pow(codec._BETA_G1, 3, O.P) == 1 and codec._BETA_G1 != 1


def test_subgroup_host_checks_match_oracle():
    rng = np.random.default_rng(4105)
    g1 = [_rand_g1_affine(rng) for _ in range(3)]
    g1.append(O.ec_to_affine(O.ec_mul(O.ec_from_affine(g1[0]), O.R)))
    g1 += [O.ec_to_affine(O.ec_mul(O.G1_GEN, k)) for k in (1, 12345)]
    assert codec._g1_subgroup_host([(x.n, y.n) for x, y in g1]) == [
        O.is_in_g1_subgroup(O.ec_from_affine(a)) for a in g1]
    g2 = [_rand_g2_affine(rng) for _ in range(2)]
    g2.append(O.ec_to_affine(O.ec_mul(O.ec_from_affine(g2[0]), O.R)))
    g2 += [O.ec_to_affine(O.ec_mul(O.G2_GEN, k)) for k in (1, 99999)]
    assert codec._g2_subgroup_host(
        [((x.c0, x.c1), (y.c0, y.c1)) for x, y in g2]) == [
        O.is_in_g2_subgroup(O.ec_from_affine(a)) for a in g2]


def test_placement_follows_the_device_and_the_override(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert not codec._use_device(torch.device("cpu"))
    assert codec._use_device(torch.device("cuda"))
    monkeypatch.setenv(ENV, "1")
    assert codec._use_device(torch.device("cpu"))
    monkeypatch.setenv(ENV, "0")
    assert not codec._use_device(torch.device("cuda"))


def test_codec_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: codec.pubkey_limbs_batch([b"\x00" * 48]),
                 lambda: codec.signature_limbs_batch([b"\x00" * 96]),
                 lambda: codec.message_limbs_batch([b""], DST),
                 lambda: tbls.prewarm_host_caches([b"fresh"], [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sha256_many_is_hashlib():
    import hashlib

    blobs = [b"", b"abc", b"\x00" * 200]
    assert codec.sha256_many(blobs) == [hashlib.sha256(b).digest()
                                        for b in blobs]


def test_codec_program_folds_match_reference():
    from consensus_specs_tpu.ops import bls_backend as jbls

    for kind in ("g1_subgroup", "g2_subgroup", "h2g_finish"):
        for n in (1, 2, 3, 8, 64, 509, 1 << 30):
            assert tbls._fold_for(kind, 0, n) == jbls._fold_for(kind, 0, n)
