"""The port's KZG/DAS plane (utils/kzg.py, utils/das.py, utils/sharding.py,
utils/custody.py and ops/kzg_backend.py) against the JAX package's, on the
CPU.

The same inputs, drawn from a seeded numpy generator, go through both
packages. Tolerance is exact: field elements compare as ints, curve points
by their compressed bytes (``g1_to_bytes`` / ``g2_to_bytes``), never by
class, and verdicts compare as bools. The batched point-proof check runs
the plain steps (``device="cpu"``); the card runs it in ``chip_smoke.py``
phase ``kzg`` and in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu.utils import bls12_381 as jO
from consensus_specs_tpu.utils import custody as jcustody
from consensus_specs_tpu.utils import das as jdas
from consensus_specs_tpu.utils import kzg as jkzg
from consensus_specs_tpu.utils import sharding as jsharding
from consensus_specs_tpu_torch.ops import kzg_backend, vm
from consensus_specs_tpu_torch.utils import bls as tbls
from consensus_specs_tpu_torch.utils import bls12_381 as tO
from consensus_specs_tpu_torch.utils import custody as tcustody
from consensus_specs_tpu_torch.utils import das as tdas
from consensus_specs_tpu_torch.utils import kzg as tkzg
from consensus_specs_tpu_torch.utils import sharding as tsharding
from tests.torch_threads import one_thread

one_thread()

SEED = 20261017
MODULUS = tkzg.MODULUS
N = 16  # polynomial / evaluation domain size
TAU = 0x5EED  # the batch cases' setup secret: the z == tau case binds it


def _rng(salt):
    return np.random.default_rng([SEED, salt])


def _field(rng, n):
    """``n`` field elements from ``rng``: 32 random bytes each, reduced."""
    return [int.from_bytes(rng.bytes(32), "big") % MODULUS for _ in range(n)]


@pytest.fixture(scope="module")
def setups():
    """Both packages' eager setups at one seeded tau, equal by bytes."""
    tau = _field(_rng(0), 1)[0]
    js, ts = jkzg.Setup(tau=tau, n=2 * N), tkzg.Setup(tau=tau, n=2 * N)
    assert [tO.g1_to_bytes(p) for p in ts.g1] == \
        [jO.g1_to_bytes(p) for p in js.g1]
    assert [tO.g2_to_bytes(p) for p in ts.g2] == \
        [jO.g2_to_bytes(p) for p in js.g2]
    return js, ts


def _same_point(tpt, jpt):
    assert tO.g1_to_bytes(tpt) == jO.g1_to_bytes(jpt)


# -- utils/kzg.py: FFT, DAS extension and recovery ----------------------------


def test_fft_and_inverse_equal_the_jax_package():
    coeffs = _field(_rng(1), N)
    evals = tkzg.fft(coeffs)
    assert evals == jkzg.fft(coeffs)
    omega = tkzg.root_of_unity(N)
    assert omega == jkzg.root_of_unity(N)
    for i in range(N):
        x = pow(omega, i, MODULUS)
        assert evals[i] == sum(c * pow(x, k, MODULUS)
                               for k, c in enumerate(coeffs)) % MODULUS
    assert tkzg.inverse_fft(evals) == jkzg.inverse_fft(evals) == coeffs
    assert tkzg.reverse_bit_order_list(coeffs) == \
        jkzg.reverse_bit_order_list(coeffs)


def test_das_extension_equals_the_jax_package():
    data = _field(_rng(2), N)
    extended = tkzg.extend_data(data)
    assert extended == jkzg.extend_data(data)
    assert extended[:N] == data
    poly = tkzg.inverse_fft(tkzg.reverse_bit_order_list(extended))
    assert all(c == 0 for c in poly[N:])
    assert tkzg.unextend_data(extended) == data


@pytest.mark.parametrize("missing", [[0], [1, 3], [0, 2, 5, 7]])
def test_recover_data_equals_the_jax_package(missing):
    rbo = tkzg.reverse_bit_order_list(tkzg.extend_data(_field(_rng(3), N)))
    per = len(rbo) // 8
    damaged = [None if i in missing else rbo[i * per:(i + 1) * per]
               for i in range(8)]
    got = tkzg.recover_data(damaged)
    assert got == jkzg.recover_data(damaged) == rbo


def test_recover_data_rejects_inconsistent_samples_on_both():
    rbo = tkzg.reverse_bit_order_list(tkzg.extend_data(_field(_rng(4), N)))
    per = len(rbo) // 8
    subgroups = [list(rbo[i * per:(i + 1) * per]) for i in range(8)]
    subgroups[7][0] = (subgroups[7][0] + 1) % MODULUS
    for pkg in (tkzg, jkzg):
        with pytest.raises(AssertionError):
            pkg.recover_data(subgroups)


# -- utils/kzg.py: commitments and proofs -------------------------------------


def test_point_proofs_equal_the_jax_package(setups):
    js, ts = setups
    rng = _rng(5)
    coeffs = _field(rng, N)
    z = _field(rng, 1)[0]
    c = tkzg.commit_to_poly(ts, coeffs)
    _same_point(c, jkzg.commit_to_poly(js, coeffs))
    proof, y = tkzg.prove_at_point(ts, coeffs, z)
    jproof, jy = jkzg.prove_at_point(js, coeffs, z)
    _same_point(proof, jproof)
    assert y == jy
    for zz, yy, want in ((z, y, True), (z, (y + 1) % MODULUS, False),
                         ((z + 1) % MODULUS, y, False)):
        assert tkzg.verify_point_proof(ts, c, proof, zz, yy) is want
        assert jkzg.verify_point_proof(js, jkzg.commit_to_poly(js, coeffs),
                                       jproof, zz, yy) is want


def test_coset_multiproofs_equal_the_jax_package(setups):
    js, ts = setups
    coeffs = _field(_rng(6), N)
    c = tkzg.commit_to_poly(ts, coeffs)
    x = pow(tkzg.root_of_unity(N), 3, MODULUS)
    proof, ys = tkzg.prove_coset(ts, coeffs, x, 4)
    jproof, jys = jkzg.prove_coset(js, coeffs, x, 4)
    _same_point(proof, jproof)
    assert ys == jys
    assert tkzg.check_multi_kzg_proof(ts, c, proof, x, ys)
    bad = [(ys[0] + 1) % MODULUS] + list(ys[1:])
    assert not tkzg.check_multi_kzg_proof(ts, c, proof, x, bad)
    assert not jkzg.check_multi_kzg_proof(
        js, jkzg.commit_to_poly(js, coeffs), jproof, x, bad)


def test_commit_to_data_and_degree_proof_equal_the_jax_package(setups):
    js, ts = setups
    rng = _rng(7)
    data = _field(rng, N)
    poly = tkzg.inverse_fft(tkzg.reverse_bit_order_list(data))
    c = tkzg.commit_to_data(ts, data)
    _same_point(c, jkzg.commit_to_data(js, data))
    assert tO.ec_eq(c, tkzg.commit_to_poly(ts, poly))
    dproof = tkzg.degree_proof(ts, poly, N)
    _same_point(dproof, jkzg.degree_proof(js, poly, N))
    assert tkzg.verify_degree_proof(ts, c, dproof, N)
    other = tkzg.commit_to_poly(ts, _field(rng, 2 * N))
    assert not tkzg.verify_degree_proof(ts, other, dproof, N)


def test_lazy_setup_caches_are_the_ports_own():
    t = tkzg.lazy_setup(TAU, 16)
    assert t is tkzg.lazy_setup(TAU, 16)
    j = jkzg.lazy_setup(TAU, 16)
    assert t is not j and type(t) is not type(j)
    assert tO.g1_to_bytes(t.g1[3]) == jO.g1_to_bytes(j.g1[3])
    assert tO.g2_to_bytes(t.g2[1]) == jO.g2_to_bytes(j.g2[1])
    assert len(t.g1) == 16 and t.n == 16


def test_key_pool_maps_kzg_work_like_the_serial_loop():
    """KeyPool.map (the smoke builds its KZG proofs with it): spawned
    processes and the serial loop give the same results, in order."""
    from consensus_specs_tpu_torch.utils.keygen import KeyPool

    orders = [2, 4, 8, 16, 32]
    want = [jkzg.root_of_unity(n) for n in orders]
    for processes in (1, 2):
        with KeyPool(processes) as pool:
            assert pool.map(tkzg.root_of_unity, orders) == want


# -- utils/das.py and utils/sharding.py ---------------------------------------


def test_das_sampling_equals_the_jax_package(setups):
    js, ts = setups
    data = _field(_rng(8), N)
    extended = tkzg.extend_data(data)
    per = 4
    count = len(extended) // per
    c = tkzg.commit_to_data(ts, extended)
    samples = tdas.sample_data(ts, extended, per)
    jsamples = jdas.sample_data(js, extended, per)
    assert [(s.index, s.data, tO.g1_to_bytes(s.proof)) for s in samples] == \
        [(s.index, s.data, jO.g1_to_bytes(s.proof)) for s in jsamples]
    assert all(tdas.verify_sample(ts, s, count, c) for s in samples)
    bad = tdas.DASSample(index=samples[0].index, proof=samples[0].proof,
                         data=[(samples[0].data[0] + 1) % MODULUS]
                         + list(samples[0].data[1:]))
    assert not tdas.verify_sample(ts, bad, count, c)
    oob = tdas.DASSample(index=samples[0].index + count,
                         proof=samples[0].proof, data=list(samples[0].data))
    assert not tdas.verify_sample(ts, oob, count, c)
    for keep in (lambda i: i % 2 == 0, lambda i: i < count // 2,
                 lambda i: i >= count // 2):
        kept = [s if keep(i) else None for i, s in enumerate(samples)]
        assert tdas.reconstruct_extended_data(kept, count, per) == \
            list(extended)


def test_sharding_fee_market_and_blob_check_equal_the_jax_package(setups):
    js, ts = setups
    rng = _rng(9)
    for price in (1000, tsharding.MAX_SAMPLE_PRICE,
                  tsharding.MIN_SAMPLE_PRICE):
        for samples in (0, tsharding.TARGET_SAMPLES_PER_BLOB,
                        tsharding.MAX_SAMPLES_PER_BLOB):
            assert tsharding.compute_updated_sample_price(
                price, samples, 64) == jsharding.compute_updated_sample_price(
                price, samples, 64)
    assert tsharding.compute_updated_sample_price(
        1000, tsharding.MAX_SAMPLES_PER_BLOB, 64) > 1000
    for epoch in (0, 63, 64 * 3 + 5):
        assert tsharding.compute_committee_source_epoch(epoch, 64) == \
            jsharding.compute_committee_source_epoch(epoch, 64)
    data = _field(rng, N)
    poly = tkzg.inverse_fft(tkzg.reverse_bit_order_list(data))
    c = tkzg.commit_to_data(ts, data)
    dproof = tkzg.degree_proof(ts, poly, N)
    assert tsharding.verify_shard_blob_commitment(ts, c, dproof, data)
    other = tkzg.commit_to_poly(ts, _field(rng, N))
    assert not tsharding.verify_shard_blob_commitment(ts, other, dproof, data)


# -- utils/custody.py ---------------------------------------------------------


@pytest.fixture
def oracle_switchboards():
    was = (tbls.bls_active, tbls._backend, jbls.bls_active)
    tbls.bls_active = jbls.bls_active = True
    tbls.use_py_ecc()
    yield
    tbls.bls_active, tbls._backend, jbls.bls_active = was


def test_legendre_bits_equal_the_jax_package():
    q = tcustody.CUSTODY_PRIME
    assert q == jcustody.CUSTODY_PRIME
    rng = _rng(10)
    for a in [int.from_bytes(rng.bytes(32), "big") % q for _ in range(20)] \
            + [0, q + 4, 4]:
        bit = tcustody.legendre_bit(a, q)
        assert bit == jcustody.legendre_bit(a, q)
        assert bit == (1 if pow(a, (q - 1) // 2, q) == 1 else 0)
    assert [tcustody.legendre_bit(a, 7) for a in range(1, 7)] == \
        [1, 1, 0, 1, 0, 0]


def test_custody_atoms_and_hash_equal_the_jax_package():
    rng = _rng(11)
    for n in (0, 1, 32, 33, 100):
        data = rng.bytes(n)
        assert tcustody.get_custody_atoms(data) == \
            jcustody.get_custody_atoms(data)
    atoms = tcustody.get_custody_atoms(rng.bytes(96))
    secrets = [int(s) for s in rng.integers(1, 1 << 62, size=3)]
    assert tcustody.universal_hash_function(atoms, secrets) == \
        jcustody.universal_hash_function(atoms, secrets)
    assert tcustody.universal_hash_function(atoms[::-1], secrets) != \
        tcustody.universal_hash_function(atoms, secrets)


def test_custody_secrets_and_bits_equal_the_jax_package(oracle_switchboards):
    rng = _rng(12)
    data = rng.bytes(512)
    for sk in (11, 12):
        key = tbls.Sign(sk, b"\x01" * 32)
        assert key == jbls.Sign(sk, b"\x01" * 32)
        secrets = tcustody.get_custody_secrets(key)
        assert secrets == jcustody.get_custody_secrets(key)
        assert len(secrets) == 3 and all(0 <= s < 2**256 for s in secrets)
        bit = tcustody.compute_custody_bit(key, data)
        assert bit in (0, 1) and bit == jcustody.compute_custody_bit(key, data)


def test_custody_periods_equal_the_jax_package():
    E = tcustody.EPOCHS_PER_CUSTODY_PERIOD
    assert E == jcustody.EPOCHS_PER_CUSTODY_PERIOD
    for index in (0, 1, 7, E - 1, E + 5):
        for epoch in (0, 1, E - 1, E, 3 * E + 17):
            period = tcustody.get_custody_period_for_validator(index, epoch)
            assert period == jcustody.get_custody_period_for_validator(
                index, epoch)
            assert tcustody.get_randao_epoch_for_custody_period(
                period, index) == jcustody.get_randao_epoch_for_custody_period(
                period, index)


# -- ops/kzg_backend.py: batched point proofs on the plain steps --------------


def _batch_cases(pkg):
    """test_kzg_backend.py's five cases (three valid proofs, a wrong y, a
    proof for another point), the constant polynomial (its proof is the
    point at infinity) and a z == tau query, built by ``pkg``'s kzg on
    the TAU setup: [(commitment, proof, z, y, truth)]."""
    setup = pkg.lazy_setup(TAU, 16)
    out = []
    for i in range(3):
        coeffs = [(7 * i + j * j + 1) % MODULUS for j in range(5 + i)]
        z = (31 * i + 2) % MODULUS
        proof, y = pkg.prove_at_point(setup, coeffs, z)
        out.append((pkg.commit_to_poly(setup, coeffs), proof, z, y, True))
    c, p, z, y, _ = out[0]
    out.append((c, p, z, (y + 1) % MODULUS, False))
    c, p, z, y, _ = out[1]
    out.append((c, p, (z + 5) % MODULUS, y, False))
    proof, y = pkg.prove_at_point(setup, [11], 4)
    out.append((pkg.commit_to_poly(setup, [11]), proof, 4, y, True))
    proof, y = pkg.prove_at_point(setup, [3, 1, 4, 1, 5], TAU)
    out.append((pkg.commit_to_poly(setup, [3, 1, 4, 1, 5]), proof, TAU, y,
                True))
    return setup, out


CASES = ["valid0", "valid1", "valid2", "wrong_y", "wrong_z", "infinity",
         "z_is_tau"]


@pytest.fixture(scope="module")
def batch_run():
    """The seven cases through the port's batch on the plain steps, once,
    with its vm.execute calls counted."""
    setup, cases = _batch_cases(tkzg)
    _, jcases = _batch_cases(jkzg)
    calls = []
    real = vm.execute

    def counted(*args, **kwargs):
        calls.append(kwargs.get("batch_shape"))
        return real(*args, **kwargs)
    vm.execute = counted
    try:
        got = kzg_backend.batch_verify_point_proofs(
            setup, *[[c[j] for c in cases] for j in range(4)], device="cpu")
    finally:
        vm.execute = real
    return got, cases, jcases, calls


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_batch_verdicts_equal_the_jax_oracle_and_the_truth(batch_run, i):
    got, cases, jcases, calls = batch_run
    tc, tp, z, y, truth = cases[i]
    jc, jp, jz, jy, _ = jcases[i]
    # both packages built the same item
    assert (tO.g1_to_bytes(tc), tO.g1_to_bytes(tp), z, y) == \
        (jO.g1_to_bytes(jc), jO.g1_to_bytes(jp), jz, jy)
    want = jkzg.verify_point_proof(jkzg.lazy_setup(TAU, 16), jc, jp, z, y)
    assert want is truth
    assert bool(got[i]) is truth
    assert got.dtype == bool and len(got) == len(CASES)
    if CASES[i] == "infinity":
        assert tp is None  # the constant polynomial's proof: infinity
    # PROG A and the hard part: two executions for the whole batch
    assert len(calls) == 2


def test_all_fallback_batch_never_calls_vm_execute(monkeypatch):
    setup, cases = _batch_cases(tkzg)
    c, p, z, y, _ = cases[-1]
    assert z == TAU

    def refuse(*args, **kwargs):
        raise AssertionError("vm.execute called for an all-fallback batch")
    monkeypatch.setattr(vm, "execute", refuse)
    got = kzg_backend.batch_verify_point_proofs(
        setup, [c, c], [p, p], [z, z], [y, (y + 1) % MODULUS], device="cpu")
    assert list(got) == [True, False]
    assert list(got) == [tkzg.verify_point_proof(setup, c, p, z, yy)
                         for yy in (y, (y + 1) % MODULUS)]
    assert len(kzg_backend.batch_verify_point_proofs(
        setup, [], [], [], [], device="cpu")) == 0


def test_batch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    setup, cases = _batch_cases(tkzg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kzg_backend.batch_verify_point_proofs(
            setup, *[[cases[0][j]] for j in range(4)])


@pytest.mark.slow
def test_batch_equals_the_jax_batch():
    """The JAX package's own batch (its VM on the CPU) on the same cases:
    the same verdicts. Marked slow as the JAX package's batch tests are."""
    from consensus_specs_tpu.ops import kzg_backend as jkzg_backend

    setup, cases = _batch_cases(tkzg)
    jsetup, jcases = _batch_cases(jkzg)
    got = kzg_backend.batch_verify_point_proofs(
        setup, *[[c[j] for c in cases] for j in range(4)], device="cpu")
    want = jkzg_backend.batch_verify_point_proofs(
        jsetup, *[[c[j] for c in jcases] for j in range(4)])
    assert list(got) == list(want) == [c[4] for c in cases]
