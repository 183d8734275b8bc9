"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present, and run
on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q

(``python3 chip_smoke.py`` runs the same comparisons at the main path's
full widths.)
"""
import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

one_thread()

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _loose(rng, shape, bits=401):
    limbs = rng.integers(0, 1 << 28, size=shape + (15,), dtype=np.int64)
    full, rest = divmod(bits, 28)
    limbs[..., full] &= (1 << rest) - 1
    limbs[..., full + 1:] = 0
    return limbs


def _to_dev(instr, dev):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(
            x.astype(np.uint8 if x.dtype == bool else np.int32))).to(dev)
        for x in instr)


def _stream(rng, n_steps, w_mul, w_lin, n_regs):
    """A random instruction stream whose reads alias the same step's writes
    and the previous step's. Every few steps two lanes write one register:
    a MUL and a LIN lane (the LIN result stays), two MUL lanes or two LIN
    lanes (the later lane's result stays)."""
    rows = []
    prev = rng.choice(n_regs, w_mul + w_lin, replace=False)
    for s in range(n_steps):
        dests = rng.choice(n_regs, w_mul + w_lin, replace=False)
        if s % 3 == 1:
            dests[w_mul + 5] = dests[1]
        if s % 4 == 2:
            dests[w_mul - 1] = dests[2]
        if s % 5 == 3:
            dests[-1] = dests[w_mul]
        reads = rng.integers(0, n_regs, size=(4, max(w_mul, w_lin)))
        reads[:, :4] = dests[:4]  # read registers this step writes
        reads[:, 4:8] = prev[:4]  # and ones the previous step wrote
        rows.append([reads[0, :w_mul], reads[1, :w_mul], dests[:w_mul],
                     reads[2, :w_lin], reads[3, :w_lin],
                     rng.random(w_lin) < 0.5, dests[w_mul:]])
        prev = dests
    return tuple(np.stack([r[i] for r in rows]) for i in range(7))


@pytest.mark.parametrize("m", [1, 255, 257, 4099, 65537])
def test_mont_mul_kernel_matches_plain(dev, m):
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    rng = np.random.default_rng(m)
    a = torch.from_numpy(_loose(rng, (m,))).to(dev)
    b = torch.from_numpy(_loose(rng, (m,))).to(dev)
    before = cuda_fq.LAUNCHES
    got = cuda_fq.mont_mul(a, b)
    assert cuda_fq.LAUNCHES == before + 1
    assert torch.equal(got, fq.mont_mul_plain(a, b))


def test_mont_mul_kernel_unaligned_operands(dev):
    """A view that starts 120 bytes into its storage is copied to 16-byte
    alignment before the bulk copies."""
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    rng = np.random.default_rng(7)
    a = torch.from_numpy(_loose(rng, (130,))).to(dev)[1:]
    b = torch.from_numpy(_loose(rng, (130,))).to(dev)[1:]
    assert a.data_ptr() % 16 != 0
    assert torch.equal(cuda_fq.mont_mul(a, b), fq.mont_mul_plain(a, b))


def test_step_kernel_matches_plain_with_aliasing(dev):
    from consensus_specs_tpu_torch.ops import cuda_step, vm

    rng = np.random.default_rng(3)
    rows, w_mul, w_lin, n_regs = 4, 96, 192, 512
    regs = torch.from_numpy(_loose(rng, (rows, n_regs))).to(dev)
    dests = rng.choice(n_regs, w_mul + w_lin, replace=False)
    reads = rng.integers(0, n_regs, size=(4, max(w_mul, w_lin)))
    reads[:, :8] = dests[:8]  # read registers this step writes
    instr = [reads[0, :w_mul], reads[1, :w_mul], dests[:w_mul],
             reads[2, :w_lin], reads[3, :w_lin],
             rng.random(w_lin) < 0.5, dests[w_mul:]]
    instr = _to_dev([x[None] for x in instr], dev)
    before = cuda_step.LAUNCHES
    got = cuda_step.run_steps(regs.clone(), instr)
    # one launch per run_steps call (here a call of one step)
    assert cuda_step.LAUNCHES == before + 1
    want = vm._vm_step_plain(regs.clone(), tuple(x[0] for x in instr))
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 3])
def test_step_kernel_multi_step_stream(dev, rows):
    """64 steps in one launch, reads aliasing writes within and across
    steps and lanes sharing destinations, against the plain steps on the
    whole register file."""
    from consensus_specs_tpu_torch.ops import cuda_step

    rng = np.random.default_rng(10 + rows)
    n_regs = 700
    regs = torch.from_numpy(_loose(rng, (rows, n_regs))).to(dev)
    instr = _to_dev(_stream(rng, 64, 96, 192, n_regs), dev)
    launches, steps = cuda_step.LAUNCHES, cuda_step.STEPS
    got = cuda_step.run_steps(regs.clone(), instr)
    assert cuda_step.LAUNCHES == launches + 1
    assert cuda_step.STEPS == steps + 64
    assert torch.equal(got, cuda_step.run_steps_plain_in_lane_order(regs,
                                                                   instr))


@pytest.mark.parametrize("n_steps", [0, 1])
def test_step_kernel_short_streams(dev, n_steps):
    from consensus_specs_tpu_torch.ops import cuda_step

    rng = np.random.default_rng(20 + n_steps)
    regs = torch.from_numpy(_loose(rng, (3, 300))).to(dev)
    instr = _to_dev(_stream(rng, max(n_steps, 1), 8, 16, 300), dev)
    instr = tuple(x[:n_steps] for x in instr)
    launches, steps = cuda_step.LAUNCHES, cuda_step.STEPS
    got = cuda_step.run_steps(regs.clone(), instr)
    assert cuda_step.LAUNCHES == launches + min(n_steps, 1)
    assert cuda_step.STEPS == steps + n_steps
    assert torch.equal(got, cuda_step.run_steps_plain_in_lane_order(regs,
                                                                   instr))


def test_step_kernel_refuses_widths_it_cannot_take(dev):
    from consensus_specs_tpu_torch.ops import cuda_step

    rng = np.random.default_rng(4)
    # w_lin not a multiple of 4; 800 MUL threads + 256 LIN threads > 1024
    for w_mul, w_lin in ((96, 6), (200, 256)):
        instr = _to_dev(_stream(rng, 2, w_mul, w_lin, 64 + w_mul + w_lin),
                        dev)
        regs = torch.zeros((1, 64 + w_mul + w_lin, 15), dtype=torch.int64,
                           device=dev)
        with pytest.raises(ValueError):
            cuda_step.run_steps(regs, instr)
    # one stamp a register in shared memory: 60,000 registers do not fit
    instr = _to_dev(_stream(rng, 2, 96, 192, 400), dev)
    regs = torch.zeros((1, 60000, 15), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        cuda_step.run_steps(regs, instr)


@pytest.mark.parametrize("w_mul,w_lin,n_regs,n_steps,threads", [
    (96, 192, 6613, 2816, 576),    # PROG A of the verify path
    (96, 192, 7189, 9728, 576),    # PROG B
    (4, 4, 80, 40, 36),            # MUL warp padded to 32 threads
    (96, 6, 500, 10, 0),           # w_lin not a multiple of 4
    (200, 256, 500, 10, 0),        # 800 + 256 threads > 1024
    (96, 192, 60000, 10, 0),       # stamps past the shared memory
    (96, 192, 500, 1 << 20, 0),    # steps past the stamps' step field
    (0, 0, 10, 10, 0),             # nothing to launch
])
def test_step_kernel_block_threads(dev, w_mul, w_lin, n_regs, n_steps,
                                   threads):
    from consensus_specs_tpu_torch.ops import cuda_step

    assert cuda_step.block_threads(w_mul, w_lin, n_regs, n_steps) == threads


def test_program_executors_agree(dev):
    from consensus_specs_tpu_torch.ops import fq, vm

    p = vm.Prog()
    a, b = p.inp("a"), p.inp("b")
    x = a
    for _ in range(20):
        x = x * b + a - x
    p.out(x, "y")
    prog = p.assemble(w_mul=4, w_lin=4)
    ins = {"a": np.stack([fq.to_mont_int(v) for v in (3, 5)]),
           "b": np.stack([fq.to_mont_int(v) for v in (7, 11)])}
    got = vm.execute(prog, ins, batch_shape=(2,), device=dev)
    want = vm.execute(prog, ins, batch_shape=(2,), device="cpu")
    assert np.array_equal(got["y"], want["y"])


def test_real_program_executors_agree(dev):
    """An assembled program of the verify path's builders, on 3 rows of
    random canonical inputs, on the card and on the CPU."""
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_step, fq, vm

    prog, _ = bls_backend._program("hard_part_frobenius", 0, 1)
    rng = np.random.default_rng(5)
    ins = {name: np.stack([fq.to_mont_int(int(rng.integers(1, 1 << 62)))
                           for _ in range(3)])
           for name in prog.input_names}
    launches = cuda_step.LAUNCHES
    got = vm.execute(prog, ins, batch_shape=(3,), device=dev)
    assert cuda_step.LAUNCHES == launches + 1
    want = vm.execute(prog, ins, batch_shape=(3,), device="cpu")
    for name in prog.output_names:
        assert np.array_equal(got[name], want[name]), name


def test_fq_mont_mul_launches_kernel_on_cuda_tensors(dev):
    """fq.mont_mul on a CUDA tensor is one launch of kernel 2."""
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    rng = np.random.default_rng(12)
    a = torch.from_numpy(_loose(rng, (33,))).to(dev)
    b = torch.from_numpy(_loose(rng, (33,))).to(dev)
    before = cuda_fq.LAUNCHES
    got = fq.mont_mul(a, b)
    assert cuda_fq.LAUNCHES == before + 1
    assert torch.equal(got, fq.mont_mul_plain(a, b))


def test_tower_combine_on_the_card_matches_cpu(dev):
    """The tower combine (one ladder launch, then a fold launch a tree
    level, no kernel-2 launch) on the card against the same function on
    the CPU (the plain loops), raw limbs equal."""
    from consensus_specs_tpu_torch.ops import cuda_fq, cuda_tower, pairing

    rng = np.random.default_rng(13)
    fs = _loose(rng, (3, 12), bits=382)
    bits = rng.random((3, 128)) < 0.5
    before, tower = cuda_fq.LAUNCHES, cuda_tower.launches()
    got = pairing.rlc_combine(torch.from_numpy(fs).to(dev),
                              torch.from_numpy(bits).to(dev))
    after = cuda_tower.launches()
    assert cuda_fq.LAUNCHES == before
    assert after["fq12_ladder"] - tower["fq12_ladder"] == 1
    assert after["fq12_fold"] - tower["fq12_fold"] == 2
    want = pairing.rlc_combine(torch.from_numpy(fs), torch.from_numpy(bits))
    assert torch.equal(got.cpu(), want)


def test_final_exp_full_on_the_card_agrees_with_the_structured_one(dev):
    """The reference-slow final exponentiation (the whole ~4314-bit
    exponent, one ladder launch) and the structured one on the card, on a
    valid Miller product e(6P, Q) * e(-P, 6Q) and on a corrupted one: both
    True, then both False."""
    from consensus_specs_tpu_torch.ops import cuda_tower, fq, pairing, towers
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    def limbs(pt):
        x, y = O.ec_to_affine(pt)
        if isinstance(x, O.Fq2):
            return [torch.from_numpy(np.stack([fq.to_mont_int(c.c0),
                                               fq.to_mont_int(c.c1)])
                                     .astype(np.int64))[None].to(dev)
                    for c in (x, y)]
        return [torch.from_numpy(fq.to_mont_int(c.n).astype(np.int64))[None]
                .to(dev) for c in (x, y)]

    p1, q1 = limbs(O.ec_mul(O.G1_GEN, 6)), limbs(O.G2_GEN)
    p2, q2 = limbs(O.ec_neg(O.G1_GEN)), limbs(O.ec_mul(O.G2_GEN, 6))
    f = towers.fq12_mul(pairing.miller_loop(*q1, *p1),
                        pairing.miller_loop(*q2, *p2))
    noise = torch.from_numpy(_loose(np.random.default_rng(17), (12,),
                                    bits=380)).to(dev)
    batch = torch.cat([f, towers.fq12_mul(f, noise)])
    before = cuda_tower.LADDER_LAUNCHES
    full = pairing.final_exp_is_one_full(batch).tolist()
    assert cuda_tower.LADDER_LAUNCHES - before == 1
    assert full == pairing.final_exp_is_one(batch).tolist() == [True, False]


def test_codec_on_the_card_matches_the_host_path(dev):
    """The batch codecs on the card (tensor path) against the raw-int host
    path, item for item, invalid encodings included."""
    from consensus_specs_tpu_torch.ops import bls_backend, codec
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    pks = [O.g1_to_bytes(O.ec_mul(O.G1_GEN, k)) for k in (3, 5)] + [
        bytes([0xC0]) + b"\x00" * 47, bytes([0x9F]) + b"\xff" * 47]
    sigs = [O.g2_to_bytes(O.ec_mul(O.G2_GEN, k)) for k in (3, 5)] + [
        bytes([0x80]) + b"\x00" * 94 + b"\x07"]
    msgs = [b"", b"abc", b"\x00" * 32]

    def norm(v):
        if isinstance(v, ValueError):
            return str(v)
        if isinstance(v, tuple):
            return tuple(np.asarray(x).tobytes() for x in v)
        return np.asarray(v).tobytes()

    for fn, items in ((codec.pubkey_limbs_batch, pks),
                      (codec.signature_limbs_batch, sigs),
                      (lambda xs, device: codec.message_limbs_batch(
                          xs, bls_backend.DST, device), msgs)):
        got = [norm(v) for v in fn(items, device=dev)]
        assert got == [norm(v) for v in fn(items, device="cpu")]


def test_service_on_the_card_with_the_real_backend(dev, monkeypatch):
    """The port's VerificationService on the card in front of the port's
    backend (tests/test_serve.py's real-backend shapes, RLC chunks of 2):
    one flush through batch_verify_rlc, exact verdicts, no fallback, each
    stage on a stream of its own."""
    from consensus_specs_tpu_torch.ops import bls_backend
    from consensus_specs_tpu_torch.serve import VerificationService
    from consensus_specs_tpu_torch.utils import bls

    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_CHUNK", "2")
    sk1, sk2 = 41, 42
    pk1, pk2 = bls.SkToPk(sk1), bls.SkToPk(sk2)
    msg = b"\x06" * 32
    agg = bls.Aggregate([bls.Sign(sk1, msg), bls.Sign(sk2, msg)])
    bls_backend.reset_call_counts()
    svc = VerificationService(max_batch=2, max_wait_ms=10_000)
    try:
        streams = {svc._prep_stream, svc._device_stream}
        assert len(streams) == 2
        assert torch.cuda.default_stream(dev) not in streams
        f_good = svc.submit("fast_aggregate", [pk1, pk2], msg, agg)
        f_bad = svc.submit("fast_aggregate", [pk1, pk1], msg, agg)
        assert f_good.result(timeout=600) is True
        assert f_bad.result(timeout=600) is False
    finally:
        svc.close(timeout=60)
    assert bls_backend.CALL_COUNTS["batch_verify_rlc"] == 1
    assert bls_backend.CALL_COUNTS["items"] == 2
    assert svc.metrics.fallback_items == 0
    assert svc.metrics.backend_retries == 0


@pytest.mark.parametrize("k", [512, 2048])
def test_wide_bucket_matches_oracle(dev, k):
    """The sync-committee (512) and mainnet-max (2048) buckets: one
    committee valid and with one signer dropped, per item and through
    RLC, against the pure-Python oracle."""
    from consensus_specs_tpu_torch.ops import bls_backend
    from consensus_specs_tpu_torch.utils import bls
    from consensus_specs_tpu_torch.utils.bls12_381 import R
    from consensus_specs_tpu_torch.utils.keygen import KeyPool

    sks = list(range(1, k + 1))
    with KeyPool() as pool:
        pks = pool.sk_to_pk(sks)
    msg = bytes([k % 251]) * 32
    sig = bls.Sign(sum(sks) % R, msg)
    sets = [pks, pks[1:]]
    want = [bls.oracle_fast_aggregate_verify(p, msg, sig) for p in sets]
    assert want == [True, False]
    got = bls_backend.batch_fast_aggregate_verify(sets, [msg, msg],
                                                  [sig, sig])
    assert [bool(g) for g in got] == want
    got = bls_backend.batch_verify_rlc(
        [("fast_aggregate", p, msg, sig) for p in sets])
    assert [bool(g) for g in got] == want


def test_epoch_slot_through_the_collector(dev):
    """One slot of the mainnet epoch (64 aggregates of 146, a sync
    aggregate of 512, a proposer check) through the port's
    SignatureCollector on the card, per item and through RLC, valid and
    with one attestation over a wrong message; spot checks against the
    oracle."""
    from consensus_specs_tpu_torch.bench import epoch_replay
    from consensus_specs_tpu_torch.utils import bls
    from consensus_specs_tpu_torch.utils.keygen import KeyPool

    with KeyPool() as pool:
        triples = epoch_replay.epoch_triples(1, 64, 146, 512, 512, pool=pool)
    assert [len(t[0]) for t in triples[-2:]] == [512, 1]
    pks, msg, sig = triples[7]
    triples[7] = (pks, b"X" + msg[1:], sig)
    col = epoch_replay.collect(triples)
    want = np.ones(66, dtype=bool)
    want[7] = False
    for i in (7, 0, 64, 65):
        c = col.checks[i]
        assert bls.oracle_fast_aggregate_verify(
            c.pubkeys, c.messages, c.signature) == want[i]
    assert np.array_equal(col.flush(), want)
    assert np.array_equal(col.flush(rlc=True), want)


def test_bls_fleet_on_the_card_answers_as_the_oracle(dev):
    """A 2-worker ``bls`` fleet on the card (each worker its own process
    and CUDA context) answers the fleet smoke's input classes (valid
    committees, a corrupted message, an undecodable signature, an
    infinity pubkey) as the pure-Python oracle does, and each worker
    reports launches of both kernels and the card's name."""
    from consensus_specs_tpu_torch.serve import fleet_smoke
    from consensus_specs_tpu_torch.serve.fleet import FleetRouter
    from consensus_specs_tpu_torch.utils import bls
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    def committee(tag, k=1, good=True):
        sks = [7000 * tag + j + 1 for j in range(k)]
        msg = (b"flt%03d" % tag) + b"\x00" * 26
        sig = bls.Sign(sum(sks) % R, msg)
        if not good:
            msg = b"\xff" + msg[1:]
        return ("fast_aggregate", [bls.SkToPk(sk) for sk in sks], msg, sig)

    items = [committee(1, k=2), committee(2), committee(3, good=False),
             ("fast_aggregate", [bls.SkToPk(7)], b"m" * 32,
              b"\xa0" + b"\x01" * 95),
             ("fast_aggregate", [b"\xc0" + b"\x00" * 47], b"p" * 32,
              bls.Sign(9, b"p" * 32))]
    want = [bls.oracle_fast_aggregate_verify(*it[1:]) for it in items]
    assert want == [True, True, False, False, False]
    with FleetRouter(workers=2, backend="bls",
                     env={"SERVE_MAX_WAIT_MS": "300"}) as router:
        assert router.device.type == "cuda"
        got = [bool(f.result(timeout=600))
               for f in [router.submit(*it) for it in items]]
        # each worker answers a valid committee of its own, so both run
        # both kernels
        for label in router.live_workers:
            assert router.handle(label).submit(*committee(10)).result(
                timeout=600) is True
        snaps = router.poll_snapshots()
    assert got == want
    assert len(snaps) == 2
    fleet_smoke.check_worker_devices(snaps, dev)


def test_world_a_replay_on_the_port_spec(dev):
    """BASELINE config 1 at 64 validators on the port's own spec (phase0
    minimal, no JAX builder): one epoch of blocks with every committee's
    attestation, built and signed by the port's helpers, replayed through
    ``replay_blocks_batched`` on the card, every check True, with the
    post-state root of the sequential replay with BLS off."""
    from consensus_specs_tpu_torch import batch_verify, builder
    from consensus_specs_tpu_torch.test.helpers.attestations import (
        next_epoch_with_attestations,
    )
    from consensus_specs_tpu_torch.test.helpers.genesis import (
        create_genesis_state,
    )
    from consensus_specs_tpu_torch.test.helpers.state import next_epoch
    from consensus_specs_tpu_torch.utils import bls

    spec = builder.build_spec_module("phase0", "minimal")
    assert spec.bls is bls
    was = (bls.bls_active, bls._backend)
    try:
        bls.bls_active = True
        bls.use_py_ecc()  # sealing's eager checks: the oracle
        state = create_genesis_state(spec, [spec.MAX_EFFECTIVE_BALANCE] * 64,
                                     spec.MAX_EFFECTIVE_BALANCE)
        next_epoch(spec, state)
        base = state.copy()
        with batch_verify.SignatureCollector(spec):
            _, blocks, _ = next_epoch_with_attestations(spec, state, True,
                                                        False)
        bls.use_gpu()
        replay = base.copy()
        ok = batch_verify.replay_blocks_batched(spec, replay, blocks)
        assert ok.all() and len(ok) > 2 * len(blocks)
        bls.bls_active = False
        plain = base.copy()
        for signed in blocks:
            spec.state_transition(plain, signed)
        assert spec.hash_tree_root(replay) == spec.hash_tree_root(plain)
    finally:
        bls.bls_active, bls._backend = was


def test_kzg_point_proofs_on_the_card(dev):
    """The KZG batch's cases (three valid proofs, a wrong y, a proof for
    another point, the constant polynomial's infinity proof and a z == tau
    query) through ``kzg_backend.batch_verify_point_proofs`` on the card:
    the constructed truth and the port's exact-int oracle, both kernels'
    results equal to the plain steps' verdicts."""
    from consensus_specs_tpu_torch.ops import cuda_step, kzg_backend
    from consensus_specs_tpu_torch.utils import kzg

    tau = 0x5EED
    setup = kzg.lazy_setup(tau, 16)
    cases = []
    for i in range(3):
        coeffs = [(7 * i + j * j + 1) % kzg.MODULUS for j in range(5 + i)]
        z = (31 * i + 2) % kzg.MODULUS
        proof, y = kzg.prove_at_point(setup, coeffs, z)
        cases.append((kzg.commit_to_poly(setup, coeffs), proof, z, y, True))
    c, p, z, y, _ = cases[0]
    cases.append((c, p, z, (y + 1) % kzg.MODULUS, False))
    c, p, z, y, _ = cases[1]
    cases.append((c, p, (z + 5) % kzg.MODULUS, y, False))
    for coeffs, z in (([11], 4), ([3, 1, 4, 1, 5], tau)):
        proof, y = kzg.prove_at_point(setup, coeffs, z)
        cases.append((kzg.commit_to_poly(setup, coeffs), proof, z, y, True))
    cols = [[c[j] for c in cases] for j in range(4)]
    launches = cuda_step.LAUNCHES
    got = kzg_backend.batch_verify_point_proofs(setup, *cols)
    assert cuda_step.LAUNCHES - launches == 2
    want = [c[4] for c in cases]
    assert list(got) == want
    assert [kzg.verify_point_proof(setup, *c[:4]) for c in cases] == want
    assert list(kzg_backend.batch_verify_point_proofs(
        setup, *cols, device="cpu")) == want


def test_world_d_replay_on_the_port_spec(dev):
    """World D at 64 validators on the port's sharding spec: from the first
    slot of epoch 1, three blocks carrying a shard header on each active
    shard (FastAggregateVerify over [builder, proposer] and the host
    degree check), the last a shard proposer slashing too, replayed
    through ``replay_blocks_batched`` on the card: every check True and
    the post-state root of the replay with BLS off."""
    from consensus_specs_tpu_torch import batch_verify, builder
    from consensus_specs_tpu_torch.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu_torch.test.helpers.genesis import (
        create_genesis_state,
    )
    from consensus_specs_tpu_torch.test.helpers.shard_blob import (
        build_shard_blob_header, build_shard_proposer_slashing,
    )
    from consensus_specs_tpu_torch.test.helpers.state import (
        state_transition_and_sign_block, transition_to,
    )
    from consensus_specs_tpu_torch.utils import bls

    spec = builder.build_spec_module("sharding", "minimal")
    was = (bls.bls_active, bls._backend)
    try:
        bls.bls_active = True
        bls.use_py_ecc()  # sealing's eager checks: the oracle
        state = create_genesis_state(spec, [spec.MAX_EFFECTIVE_BALANCE] * 64,
                                     spec.MAX_EFFECTIVE_BALANCE)
        transition_to(spec, state, int(spec.SLOTS_PER_EPOCH))
        base = state.copy()
        blocks = []
        with batch_verify.SignatureCollector(spec):
            for i in range(3):
                block = build_empty_block_for_next_slot(spec, state)
                for shard in range(int(spec.INITIAL_ACTIVE_SHARDS)):
                    block.body.shard_headers.append(build_shard_blob_header(
                        spec, state, slot=state.slot, shard=shard,
                        data_seed=10 * i + shard + 1))
                if i == 2:
                    block.body.shard_proposer_slashings.append(
                        build_shard_proposer_slashing(spec, state,
                                                      slot=state.slot))
                blocks.append(state_transition_and_sign_block(spec, state,
                                                              block))
        bls.use_gpu()
        replay = base.copy()
        ok = batch_verify.replay_blocks_batched(spec, replay, blocks)
        # a proposer signature, a randao reveal and two headers a block,
        # and the slashing's two
        assert ok.all() and len(ok) == 4 * len(blocks) + 2
        bls.bls_active = False
        plain = base.copy()
        for signed in blocks:
            spec.state_transition(plain, signed)
        assert spec.hash_tree_root(replay) == spec.hash_tree_root(plain)
    finally:
        bls.bls_active, bls._backend = was


def test_light_client_update_verified_on_the_card(dev):
    """An altair minimal ProofWorld's update through a ProofService whose
    verifier is a VerificationService on the card, then the spec's
    validate_light_client_update with the switchboard on the card; an
    update signed under a wrong key comes back False from both."""
    from consensus_specs_tpu_torch import builder
    from consensus_specs_tpu_torch.lightclient import (
        ProofService, ProofWorld, build_update_artifact, verify_artifact)
    from consensus_specs_tpu_torch.ops import cuda_step
    from consensus_specs_tpu_torch.serve.service import VerificationService
    from consensus_specs_tpu_torch.utils import bls

    bls.use_gpu()
    spec = builder.build_spec_module("altair", "minimal")
    world = ProofWorld(spec)
    slot = world.finalized_slot + 1
    state = world.head_state(slot)
    root = bytes(state.hash_tree_root())

    def wrong_key(signing_root):
        return [True] * len(world.sks), bls.Sign(
            (sum(world.sks) + 1) % bls.R, bytes(signing_root))

    before = cuda_step.LAUNCHES
    with VerificationService(max_wait_ms=5.0) as verifier:
        good = ProofService(verifier=verifier).serve(
            slot, root, lambda: world.build_artifact(slot))
        bad = ProofService(verifier=verifier).serve(
            slot, root, lambda: build_update_artifact(
                spec, state, world.finalized_state,
                genesis_validators_root=world.genesis_validators_root,
                sign=wrong_key))
    assert good.verified is True and bad.verified is False
    assert cuda_step.LAUNCHES > before
    verify_artifact(spec, good, world.snapshot,
                    world.genesis_validators_root, state_root=root)
    with pytest.raises(AssertionError):
        verify_artifact(spec, bad, world.snapshot,
                        world.genesis_validators_root, state_root=root)
