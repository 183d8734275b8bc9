"""The ``mesh=`` of the port's subgroup-checking batch codecs and of
KZG's batched point proofs on a 4-slot CPU mesh, each held against the
same call unsharded: ``g1_subgroup_check_batch``,
``g2_subgroup_check_batch``, ``pubkey_limbs_batch`` and
``signature_limbs_batch`` on their tensor path
(CONSENSUS_SPECS_TPU_CODEC_DEVICE=1: the subgroup programs on the plain VM
steps), and ``kzg_backend.batch_verify_point_proofs``. Every sharded call
must reach ``vm.execute`` with the mesh and give the unsharded call's
limbs, errors and verdicts. tests/test_torch_mesh_hash.py does the same
for the three hash-to-G2 codecs with this module's helpers.

The codecs of one program family (the G1 subgroup check under
``pubkey_limbs_batch``, the G2 one under ``signature_limbs_batch``, the
hash finish under ``hash_to_g2_batch`` and ``message_limbs_batch``) hand
``vm.execute`` the same program and inputs, so ``execute_meshes`` runs
each (program, inputs, rows, device, mesh) once and gives the later calls
a copy of its outputs: each family pays one sharded and one unsharded run
of its program on the plain steps."""
import functools

import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu_torch.ops import bls_backend as bb
from consensus_specs_tpu_torch.ops import codec, kzg_backend, vm
from consensus_specs_tpu_torch.utils import bls, kzg
from consensus_specs_tpu_torch.utils import bls12_381 as O
from consensus_specs_tpu_torch.utils import torch_env

one_thread()

CPU = torch.device("cpu")
DST = bb.DST
MSG = b"\x05" * 32

# (program id, rows, device, mesh, inputs) -> outputs of vm.execute
_RUNS = {}


@pytest.fixture()
def mesh():
    return torch_env.make_mesh(4, CPU)


@pytest.fixture()
def execute_meshes(monkeypatch):
    """The ``mesh`` of every ``vm.execute`` call, in order; each distinct
    call runs once in this module."""
    seen = []
    real = vm.execute

    def once(program, inputs, batch_shape=(), device=None, mesh=None):
        seen.append(mesh)
        key = (id(program), tuple(batch_shape), device, mesh,
               tuple(sorted((k, v.tobytes()) for k, v in inputs.items())))
        if key not in _RUNS:
            _RUNS[key] = real(program, inputs, batch_shape=batch_shape,
                              device=device, mesh=mesh)
        return {k: v.copy() for k, v in _RUNS[key].items()}

    monkeypatch.setattr(vm, "execute", once)
    return seen


def _off_subgroup_g1() -> bytes:
    """A G1 point on y^2 = x^3 + 4 outside the order-r subgroup."""
    x = 5
    while True:
        y = O.fq_sqrt((x ** 3 + 4) % O.P)
        if y is not None:
            pt = O.ec_from_affine((O.Fq(x), O.Fq(y)))
            if not O.is_in_g1_subgroup(pt):
                return O.g1_to_bytes(pt)
        x += 1


def _off_subgroup_g2() -> bytes:
    """A G2 point on the twist outside the order-r subgroup."""
    x0 = 3
    while True:
        x = O.Fq2(x0, 1)
        y = (x * x * x + O.B_G2).sqrt()
        if y is not None:
            pt = O.ec_from_affine((x, y))
            if not O.is_in_g2_subgroup(pt):
                return O.g2_to_bytes(pt)
        x0 += 1


def _pubkeys():
    return [bls.SkToPk(41), bls.SkToPk(42), _off_subgroup_g1(),
            b"\xc0" + b"\x00" * 47]


def _signatures():
    return [bls.Sign(41, MSG), bls.Sign(42, b"\x06" * 32),
            _off_subgroup_g2(), b"\xc0" + b"\x00" * 95]


MESSAGES = [b"\x01" * 32, b"\x02" * 32, b"abc"]


def _norm(v):
    """Limb payloads by bytes, ValueErrors by message."""
    if isinstance(v, ValueError):
        return ("err", str(v))
    if isinstance(v, tuple):
        return ("ok", tuple(np.asarray(x).tobytes() for x in v))
    return ("ok", np.asarray(v).tobytes())


def _g1_points():
    res = codec.decompress_g1_batch(_pubkeys()[:3], CPU)
    return np.stack([np.stack(v) for v in res])


def _g2_points():
    res = codec.decompress_g2_batch(_signatures()[:3], CPU)
    return np.stack(res)


@functools.lru_cache(maxsize=None)
def h2g_inputs():
    """The SSWU outputs q0, q1 that hash_to_g2_batch hands its finish."""
    seen = {}
    real = codec._h2g_finish_batch

    def spy(q0, q1, device, mesh=None):
        seen["q"] = (q0, q1)
        return real(q0, q1, device, mesh=mesh)

    codec._h2g_finish_batch = spy
    try:
        codec.hash_to_g2_batch(MESSAGES, DST, CPU)
    finally:
        codec._h2g_finish_batch = real
    return seen["q"]


CODEC_CALLS = {
    "g1_subgroup_check_batch": lambda mesh: codec.g1_subgroup_check_batch(
        _g1_points(), CPU, mesh=mesh),
    "g2_subgroup_check_batch": lambda mesh: codec.g2_subgroup_check_batch(
        _g2_points(), CPU, mesh=mesh),
    "pubkey_limbs_batch": lambda mesh: codec.pubkey_limbs_batch(
        _pubkeys(), CPU, mesh=mesh),
    "signature_limbs_batch": lambda mesh: codec.signature_limbs_batch(
        _signatures(), CPU, mesh=mesh),
}


def check_sharded(call, mesh, execute_meshes, monkeypatch):
    """``call(mesh)`` on the codec's tensor path equals ``call(None)``
    (limbs by bytes, errors by message), and its program ran on the
    mesh; returns the sharded result."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_CODEC_DEVICE", "1")
    want = call(None)
    del execute_meshes[:]
    got = call(mesh)
    assert execute_meshes and execute_meshes[-1] is mesh
    if isinstance(want, list):
        assert [_norm(v) for v in got] == [_norm(v) for v in want]
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)
    return got


@pytest.mark.parametrize("name", list(CODEC_CALLS))
def test_codec_sharded_equals_unsharded(name, mesh, execute_meshes,
                                        monkeypatch):
    """Subgroup verdicts (the off-subgroup points False), limbs and
    per-item errors (off the subgroup, infinity) equal the unsharded
    call's; the program ran on the mesh."""
    got = check_sharded(CODEC_CALLS[name], mesh, execute_meshes,
                        monkeypatch)
    if name.endswith("subgroup_check_batch"):
        assert list(got) == [True, True, False]


def test_kzg_point_proofs_sharded_equal_unsharded(mesh, execute_meshes):
    """Two valid proofs, a wrong y and a proof for another point: the
    verdicts of the unsharded batch and the truth."""
    setup = kzg.lazy_setup(0x5EED, 16)
    cases = []
    for i in range(2):
        coeffs = [(7 * i + j * j + 1) % kzg.MODULUS for j in range(5 + i)]
        z = (31 * i + 2) % kzg.MODULUS
        proof, y = kzg.prove_at_point(setup, coeffs, z)
        cases.append((kzg.commit_to_poly(setup, coeffs), proof, z, y))
    c, p, z, y = cases[0]
    cases.append((c, p, z, (y + 1) % kzg.MODULUS))
    c, p, z, y = cases[1]
    cases.append((c, p, (z + 5) % kzg.MODULUS, y))
    cols = [[case[j] for case in cases] for j in range(4)]
    want = kzg_backend.batch_verify_point_proofs(setup, *cols, device=CPU)
    got = kzg_backend.batch_verify_point_proofs(setup, *cols, mesh=mesh)
    assert mesh in execute_meshes
    assert list(got) == list(want) == [True, True, False, False]

