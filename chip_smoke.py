#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``consensus_specs_tpu_torch`` (never jax, never the JAX package)
through twenty-one phases, each printing one JSON line:

  1. build   -- compile every CUDA kernel of the port from csrc/ with nvcc
               for sm_90a (one nvcc per source, all started together);
  2. kernels -- hold each kernel against its plain PyTorch version on the
               card, limb-exact, and time both (CUDA events): mont_mul at
               65,536 and 65,537 products, and one synthetic step kernel
               call whose writes alias its reads and in which pairs of
               lanes write one register (then 2,000 such steps in one
               launch, timed);
  3. program -- one assembled VM program (hard_part_frobenius, fold 1) on
               the CUDA executor against the plain executor, limb-exact;
  4. slice   -- the main path at mainnet size: batch_fast_aggregate_verify
               over one slot of 64 committee aggregates of 146 members
               (300k validators / 32 slots / 64 committees), 4 of them
               planted invalid; the verdicts must equal the planted ones,
               three items must agree with the pure-int pairing oracle, and
               the step kernel must have been launched once per
               vm.execute (its launch and step counts are printed);
  5. kernels -- the slice's two real instruction streams (PROG A
               miller_product k160 fold 8 on 8 rows, PROG B hard_part
               fold 32 on 2 rows) on random canonical inputs: the first
               256 steps limb for limb against the plain version, then
               each full stream timed in one launch, beside its bound and
               its latency floor (steps x one L2 round trip);
  6. rlc     -- batch_verify_rlc at the same mainnet size: the all-valid
               slot (cold, then warm best of 3: every verdict True, one
               combine, one final exponentiation, no bisection, one
               step-kernel launch per vm.execute), the per-item path on it
               warm in the same call, the planted slot
               (verdicts equal to the planted ones and to phase 4's), and
               the tower combine (every Fq12 product a Montgomery-kernel
               launch) equal to the VM combine on the same inputs; then the
               first 256 steps of the real rlc_combine call, fed PROG A's
               loose outputs, limb for limb against the plain version, and
               the Montgomery kernel against its plain version at the tower
               combine's shapes;
  7. codec   -- the batched input codec (ops/codec.py) at a slot's prep
               sizes (512 pubkeys, 64 signatures, 64 messages = 128 SSWU
               draws, with invalid encodings, points outside the subgroup
               and infinity): each field function on the card against the
               plain CPU path limb for limb, the batch codecs on the card
               against the raw-int host path item for item; the first 256
               steps of g1_subgroup, g2_subgroup and h2g_finish against
               the plain version, each whole stream timed; the Montgomery
               kernel at 512, 128 and 64 products; each exponentiation
               chain step by step against its CUDA-graph replay; then a
               fresh slot (new messages and signatures from phase 4's key
               pool, pubkeys cached) through batch_fast_aggregate_verify
               and batch_verify_rlc, each with the codec prep (and once
               with its chains step by step) and with per-item prep
               (CONSENSUS_SPECS_TPU_BATCH_CODEC=0), verdicts
               equal to the planted ones, walls split into codec prep
               (decode, subgroup checks, hash), assembly, vm.execute and
               easy part; the pool's 512 pubkeys prepared cold both ways,
               and one fresh item both ways.
  8. serve   -- the serve plane: the port's VerificationService on the
               card (its prep and device stages on CUDA streams of their
               own) in front of the port's backend, at the JAX serve
               bench's knobs (max_batch 32, max_wait 20 ms, Poisson
               arrivals at 256 Hz): a new slot of phase 4's key pool (64
               aggregates of 146, the same 4 planted) heard over 256
               submits, the later half of the committees joining in the
               stream's second half. Every verdict exact; no retry, no
               fallback, no prep/RLC/backend error, codec prep only, one
               backend item per distinct check, and at least one chain
               graph captured inside the stream; its kernel launches,
               latencies, occupancy, prep/device split and the overlap of
               the prep (host) and card lanes of the occupancy ledger are
               printed. Then the same distinct checks through one
               batch_verify_rlc call (the offline floor), and the port's
               serve/load.run_serve_bench at its defaults (8 committees
               of 8, 64 events) behind FailingBackendProxy, which falls
               back on purpose: calls 1-2 failing (the poisoned flush
               served by the per-group path) and calls 1-4 failing
               (served by the oracle, journalled and warned about), every
               verdict right and later flushes served by the backend.

  9. wide    -- the wide buckets on the card: one committee of 512 and one
               of 2,048 keys (the sync committee and the mainnet maximum),
               valid and with one signer dropped, through
               batch_fast_aggregate_verify and batch_verify_rlc, first and
               warm, each run's step-kernel ms and launches printed.
 10. epoch   -- BASELINE config 4 through the port's SignatureCollector:
               32 slots x (64 attestation aggregates of 146 signers from a
               pool of 512 keys + a sync aggregate of 512 + a proposer
               check) = 2,112 checks, 315,424 signatures, through
               flush(), flush(rlc=True) and flush(service=) (a new
               VerificationService a run): first, warm and fresh (messages
               and signatures evicted, so the codec prepares them), each
               wall against the north star's 2 s and split into prep,
               assembly, vm.execute, easy part and the RLC host fold; then
               the epoch with 4 planted checks across the buckets, every
               verdict exact and the planted ones and a sample of valid
               ones equal to the oracle's. Any fallback, retry or ladder
               record fails it.
 11. mainnet -- the port's scale/smoke.py rounds at 8,192 validators
               (valid, censored, bad committee; hierarchical == flat ==
               oracle), then one slot of a 1,048,576-validator registry (64
               committees of 512) through the hierarchical fold: cold and
               warm attestations/s, one final exponentiation a slot, a
               pubkey hit rate of 1 on the warm round, the pubkey plane
               within its budget, peak RSS, and a planted bad committee
               localized by bisection and checked against the oracle with
               one other committee.
 12. spec    -- the port's own executable spec (its builder, SSZ and
               phase0/altair sources; no spec of the JAX package) with its
               switchboard on the card. World A, BASELINE config 1: phase0
               minimal, 2,048 validators (4 committees of 64 a slot), one
               epoch of 8 blocks carrying ~28 full aggregates, built by the
               port's helpers; world B, config 3: altair mainnet, 1,024
               validators, two blocks with sync aggregates of 512 and 384
               seats. Each world replayed three ways from its genesis:
               replay_blocks_batched on the card, state_transition with
               every check its own card call, and BLS off; equal
               post-state roots after every block, every check True;
               routes 1 and 2 cold and warm, blocks/s, signatures/s and
               each wall split into host state transition, codec prep,
               vm.execute and easy part. A planted check in each world
               (an aggregate over another message; a sync bit cleared with
               the signature kept) flagged alone, the oracle agreeing.
               Then world A's epoch through HeadService over a
               VerificationService on the card, differential on: two
               early aggregates deferred then applied, two BAD_SIGNATURE
               attestations dropped, gossip->head p50/p99. Aggregates are
               signed as Sign(sum sk), shown equal on one committee of
               each world to the helpers' member-by-member Aggregate.
 13. kzg     -- BASELINE config 5 at full width: 256 KZG point proofs
               (the sharding mainnet preset's 64 active shards x 4
               headers: 64 polynomials of 8 coefficients, each proved at 4
               points with the port's commit_to_poly and prove_at_point)
               against the port's own sharding mainnet setup (16,384
               lazy points), 8 of them false (wrong y, wrong z, another
               polynomial's proof), a constant polynomial (its proofs
               are the point at infinity) and a z == tau item, through
               kzg_backend.batch_verify_point_proofs on the card (PROG A
               aggregate_verify k2 fold 8 on 32 rows, the hard part fold
               32 on 8 rows): cold, then twice warm, every verdict the
               constructed truth, each wall split into host scalar prep,
               vm.execute, step kernels, easy part and hard part; the
               exact-int oracle agreeing on the 10 planted or edge items
               and 16 valid ones; the z == tau item alone launching
               nothing. Its items are oracle points, so it launches no
               Montgomery kernel.
 14. forks   -- the port's merge, sharding and custody_game specs with the
               switchboard on the card. World C: merge minimal, 1,024
               validators, after the complete transition, one epoch of 8
               blocks with attestations and empty execution payloads;
               world D: sharding minimal (2 active shards), 2,048
               validators, from the first slot of epoch 1: shard headers
               on both shards in 4 blocks (a FastAggregateVerify over
               [builder, proposer] and two host pairings each) and a
               shard proposer slashing; world E: custody_game minimal, 128
               validators walked through 31 epochs of empty slots, the 8
               blocks of epoch 31 with attestations, the last with
               custody key reveals (eager Verify calls) and an early
               derived secret reveal (AggregateVerify). Each replayed
               three ways as in phase 12, equal roots after every
               block, and a planted check a world
               (an aggregate over another message; a header with another
               header's signature; a masked reveal over another message)
               flagged alone, the oracle agreeing.
Phases 9-14 and 16 build their keys, signatures and KZG proofs in a pool
of spawned processes (utils/keygen.py).
 15. fleet   -- the serve fleet on the card: FleetRouter with 2 bls worker
               processes (each its own CUDA context). (a) the port's
               serve/fleet_smoke.main: verdict identity fleet ==
               single process == oracle over every input class, every
               worker on the card with launches of both kernels, then a
               forced worker fault -> SLO-burn shed/drain decision
               rebuilt from the merged journal; then, on a fleet at phase
               8's knobs, (b) phase 8's stream (same slot, picks and
               Poisson gaps) through the router: the planted verdicts and
               phase 8's, none lost, no fallback, retry or ladder record,
               its rates, latencies and each worker's flushes, launches
               and prep/device split beside phase 8's; (d) phase 11's
               slot (64 committees of 512, committee 32 bad) twice
               through CommitteeFleet: verify_slot's verdicts, a stable
               assignment, 0 affinity moves; (c) one worker armed to fail
               until the router sheds or drains it (falls back on
               purpose). The workers' launch counts are summed and their
               launch shapes (from their snapshots) join phase 21.
 16. lightclient -- the light-client proof plane on the port's altair
               mainnet spec: a ProofWorld of the full 512-seat sync
               committee (keys from the spawn pool, equal to SkToPk's) over
               a registry of 300,000 validators (BASELINE.json's); 1 head
               slot behind one ProofService whose verifier is a
               VerificationService on the card at phase 8's knobs. Each
               artifact built once, its sync-committee FastAggregateVerify
               (k512) verdict True from the card service, then checked in
               full: validate_light_client_update (the switchboard on the
               card), the combined multiproof, and the finality branch
               against a state re-Merkleized from a fresh decode_bytes.
               Then 100,000 requests (the 1 build among them) round-robin
               from 4 threads, each paying is_valid_merkle_branch: hit
               rate (N - R)/N, proofs served/s, p50/p99 proof_serve. An
               update signed under a wrong key (verified False, the spec's
               validation raises) and a flipped finality-branch byte must
               be flagged; no fallback, retry or ladder record. Then the
               port's proof smoke (minimal, 32 seats) on 2 bls workers on
               the card, each launching both kernels.
 17. sim     -- the port's simnet, every node's service on the card over
               the crypto-free VerdictBackend: sim/smoke.main
               (partition_heal, 4 nodes, strict gate), every scenario of
               the library under the strict gate with light-client
               evidence, partition_heal replayed on 2 verdict worker
               processes on the card (each naming the card), and
               sim/latency_smoke.main. No kernel is launched, by design.
 18. spec_tests -- the 72 ``@always_bls`` cases of the port's spec tests,
               50 of phase0 (test/phase0/) and 22 of altair
               (test/altair/: sync aggregates of 32 signers), picked by
               the ``bls_setting`` the port's decorators carry outward,
               each on its fork, on the minimal preset in
               generator mode with the switchboard on the card
               (``bls.use_gpu()``): every signature check they make goes
               through ops/bls_backend's per-call verify,
               fast_aggregate_verify or aggregate_verify. The spec's own
               asserts are the oracle: a valid signature the card refuses
               fails its case, an invalid one it accepts fails
               ``expect_assertion_error``. Each card call and each
               exception in it is counted; any exception but a decode
               ValueError/TypeError on an input the oracle also rejects
               fails the phase, as does any call of the oracle's verify
               functions in the span, a case that does not pass, or
               either kernel not launched, or a fork with no card call.
               Seconds split into host signing (Sign, Aggregate, SkToPk),
               card calls and the rest; calls, verdicts and seconds also
               by fork.
 19. gen     -- the port's test-vector generators: ``bls`` (29 cases)
               into a temporary directory with every cross-check on the
               card (gen/generators/bls.py: expected verdicts from the
               oracle, pinned for the run; the check through
               ops/bls_backend's verify, fast_aggregate_verify and
               aggregate_verify), then ``ssz_generic``, ``shuffling -l
               minimal`` and ``merkle -l minimal`` on the card's host.
               Fails unless all 29 cases are written (none failed or left
               INCOMPLETE), the 15 checks equal the oracle's verdicts (12
               card calls; the 3 the backend answers before the device,
               two empty pubkey lists and a length mismatch, launch
               nothing), no check raises, the oracle's verify functions
               run 0 times inside a backend call, both kernels launch,
               the switchboard is restored, and every tree's digest
               equals gen/digests.PINNED (the JAX package's trees: the
               YAML writer on a machine without PyYAML).
 20. bench   -- the port's bench entry (bench/entry.main, as
               ``python -m consensus_specs_tpu_torch.bench --mode M``
               runs it) in this process, once a mode, at BENCH_MODES'
               knobs: committee at 32 x 128 (3 reps), the epoch at the
               mainnet shape (1 rep), codec, rlc, head, mainnet at 262,144
               validators (1 slot, 2 fleet workers), serve, serve-fleet
               at 1 and 2 workers, latency, soak (8 epochs), merkle,
               proofs and sim. Each mode's line must carry no error,
               platform gpu and the card's name, every gate flag true and
               no ladder record (serve injects its fault on purpose);
               committee, epoch and codec together must launch both
               kernels. One line a mode, then the phase's summary.
 21. kernels -- every program and row count that phases 9-16 and 18-20
               launched the step kernel at (noted during those phases) and that no
               earlier phase checked: the first 256 steps on random
               canonical inputs limb for limb against the plain version,
               then each whole stream timed, as in phase 5.

Then it prints the card's name and power limit, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""
import contextlib
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM data-sheet rate: HBM bandwidth.
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds issued per SM per clock on Hopper (the INT32
# pipe: 16 lanes in each of the SM's 4 partitions); the rate is this times
# the SM count and the card's maximum SM clock, both read at run time.
IMAD_PER_SM_CLOCK = 64
# A 28x28-bit limb product accumulated into 64 bits is one 32x32->64
# multiply-add, counted as two 32-bit IMADs (low and high halves).
IMAD_PER_WIDE_MAC = 2
# Montgomery product over 15 limbs: 225 schoolbook products, 15 reduction
# factors m_i, 225 products m_i * p_j.
WIDE_MACS_PER_MONT = 225 + 15 + 225
# LIN lane: 15 limbs of (complement, add, add carry, mask, shift).
INT_OPS_PER_LIN = 15 * 5
LIMB_BYTES = 8  # int64 limbs
# torch.cuda._sleep spins for SM clocks; 2e9 a second is above the H100's
# maximum SM clock, so a sleep lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2e9
# L2 hit latency of Hopper in SM clocks, about 260 in published pointer-
# chase microbenchmarks of the H100 (an estimate, not measured here): one
# dependent VM step cannot take less than one such round trip for its
# operands, so steps x this is a call's latency floor.
L2_HIT_CYCLES = 260


class SmokeFailure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _ptxas_summary(log):
    """Registers a thread and spill bytes from nvcc's -Xptxas -v report."""
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    return {"registers": [int(r) for r in regs],
            "spill_bytes": [int(a) + int(b) for a, b in spills]}


def _cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call. The stream first sleeps on the card for twice as long as
    the host takes to enqueue the calls, so the events time the device's
    work back to back and not the host's Python between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * reps * host_s, 2.0) * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _rand_loose_limbs(rng, shape, bits=401):
    """Random loose residues below 2^bits as (..., 15) int64 limbs < 2^28."""
    limbs = rng.integers(0, 1 << 28, size=tuple(shape) + (15,), dtype=np.int64)
    full, rest = divmod(bits, 28)
    limbs[..., full] &= (1 << rest) - 1
    limbs[..., full + 1:] = 0
    return limbs


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def phase_mont_mul(torch, dev, rng, imad_rate):
    """The kernel against the plain version at 65,536 products and at 65,537
    (a ragged last chunk), limb for limb; times at 65,536."""
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    m = 65536
    a = torch.from_numpy(_rand_loose_limbs(rng, (m + 1,))).to(dev)
    b = torch.from_numpy(_rand_loose_limbs(rng, (m + 1,))).to(dev)
    err = 0
    for n in (m, m + 1):
        got = cuda_fq.mont_mul(a[:n], b[:n])
        torch.cuda.synchronize()
        e = int((got - fq.mont_mul_plain(a[:n], b[:n])).abs().max().item())
        _check(e == 0, f"mont_mul kernel (M={n}) differs from plain: "
                       f"max |err| {e}")
        _check(int(got.max().item()) < (1 << 28), "mont_mul limbs not carried")
        err = max(err, e)
    a, b = a[:m].contiguous(), b[:m].contiguous()
    ms = _cuda_ms(torch, lambda: cuda_fq.mont_mul(a, b), 200)
    plain_ms = _cuda_ms(torch, lambda: fq.mont_mul_plain(a, b), 10)
    n_bytes = 3 * m * 15 * LIMB_BYTES
    n_ops = m * WIDE_MACS_PER_MONT * IMAD_PER_WIDE_MAC
    return {
        "name": "mont_mul", "products": m, "ragged_checked": m + 1,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bytes": n_bytes, "imad": n_ops, **_bound(n_bytes, n_ops, imad_rate),
    }


def _synthetic_step(rng, rows, w_mul, w_lin, n_regs):
    """One full-width VM step whose writes alias some of its reads: random
    loose registers, sub lanes' b below 2^381. Most destinations are
    distinct; three pairs of lanes write one register (a MUL and a LIN
    lane: the LIN result stays; two MUL lanes and two LIN lanes: the later
    lane's result stays)."""
    regs = _rand_loose_limbs(rng, (rows, n_regs))
    msa = rng.integers(0, n_regs, w_mul, dtype=np.int32)
    msb = rng.integers(0, n_regs, w_mul, dtype=np.int32)
    lsa = rng.integers(0, n_regs, w_lin, dtype=np.int32)
    lsb = rng.integers(0, n_regs, w_lin, dtype=np.int32)
    lsub = rng.random(w_lin) < 0.5
    dests = rng.choice(n_regs, w_mul + w_lin, replace=False).astype(np.int32)
    msd, lsd = dests[:w_mul], dests[w_mul:]
    lsd[40] = msd[3]  # different warps of the block
    msd[w_mul - 1] = msd[5]
    lsd[w_lin - 1] = lsd[50]
    # read-before-write: lanes read registers this step also writes
    msa[:8] = lsd[:8]
    msb[8:16] = msd[:8]
    lsa[:8] = msd[8:16]
    lsb[8:16] = lsd[16:24]
    for r in np.unique(lsb[lsub]):
        regs[:, r] = _rand_loose_limbs(rng, (rows,), bits=381)
    return regs, (msa, msb, msd, lsa, lsb, lsub, lsd)


def phase_vm_step(torch, dev, rng, imad_rate):
    from consensus_specs_tpu_torch.ops import cuda_step, vm

    rows, w_mul, w_lin, n_regs = 8, 96, 192, 4096
    regs_np, instr_np = _synthetic_step(rng, rows, w_mul, w_lin, n_regs)
    aliased = set(instr_np[2].tolist() + instr_np[6].tolist()) & set(
        np.concatenate([instr_np[i] for i in (0, 1, 3, 4)]).tolist())
    _check(len(aliased) >= 16, "synthetic step does not alias reads/writes")

    def to_dev(x):
        x = x.astype(np.uint8) if x.dtype == bool else x
        return torch.from_numpy(np.ascontiguousarray(x[None])).to(dev)

    instr = tuple(to_dev(x) for x in instr_np)
    regs0 = torch.from_numpy(regs_np).to(dev)
    got = cuda_step.run_steps(regs0.clone(), instr)
    # the plain step, the later of two MUL or two LIN lanes keeping a
    # register they share (a scatter with a repeated index keeps either)
    want = cuda_step.run_steps_plain_in_lane_order(regs0, instr)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item())
    _check(err == 0, f"vm_step kernel differs from plain: max |err| {err}")

    # time: the same step repeated, one launch of 2,000 steps
    reps = 2000
    instr_rep = tuple(x.expand(reps, -1).contiguous() for x in instr)
    work = regs0.clone()
    before = cuda_step.LAUNCHES
    cuda_step.run_steps(work, instr_rep)
    _check(cuda_step.LAUNCHES - before == 1,
           "a run_steps call made other than one launch")
    ms = _cuda_ms(torch, lambda: cuda_step.run_steps(work, instr_rep), 1) / reps
    plain_work = regs0.clone()
    one = tuple(x[0] for x in instr)
    plain_ms = _cuda_ms(torch, lambda: vm._vm_step_plain(plain_work, one), 20)

    n_read = len(set(np.concatenate(
        [instr_np[i] for i in (0, 1, 3, 4)]).tolist()))
    n_write = len(set(instr_np[2].tolist() + instr_np[6].tolist()))
    instr_bytes = sum(x.nbytes for x in instr_np)
    n_bytes = rows * (n_read + n_write) * 15 * LIMB_BYTES + instr_bytes
    n_ops = rows * (w_mul * WIDE_MACS_PER_MONT * IMAD_PER_WIDE_MAC
                    + w_lin * INT_OPS_PER_LIN)
    return {
        "name": "vm_step", "stream": "synthetic", "rows": rows,
        "w_mul": w_mul, "w_lin": w_lin, "n_regs": n_regs,
        "aliased_regs": len(aliased), "shared_dests": w_mul + w_lin - n_write,
        "max_abs_err": err,
        "us_per_step": ms * 1e3, "timed_steps": reps,
        "plain_ms_per_step": plain_ms, "bytes_per_step": n_bytes,
        "imad_per_step": n_ops, **_bound(n_bytes, n_ops, imad_rate),
    }


# the verify path's two programs, with the kinds and folds that
# bls_backend._fold_for gives the mainnet slot (64 items, k bucket 160)
MAIN_STREAMS = (
    ("PROG A", "miller_product", 160, 8, 8),
    ("PROG B", "hard_part", 0, 32, 2),
)
CHECK_STEPS = 256


def _canonical_limbs(rng, shape):
    """Random canonical residues (< p) as (..., 15) int64 limbs: limbs
    0..12 uniform, limb 13 below p's, limb 14 zero."""
    from consensus_specs_tpu_torch.ops import fq

    limbs = rng.integers(0, 1 << 28, size=tuple(shape) + (15,), dtype=np.int64)
    limbs[..., 13] = rng.integers(0, int(fq.P_LIMBS[13]), size=shape)
    limbs[..., 14] = 0
    return limbs


def _stream_work(instr, n_regs, rows):
    """Bytes, operations and real lanes of one run_steps call over the
    numpy instruction tensors ``instr`` on ``rows`` rows of ``n_regs``
    registers: the instruction stream once, the register file in and out
    once, and the real lanes' arithmetic (idle lanes, which read register
    0 twice, are not counted)."""
    msa, msb, _, lsa, lsb, _, _ = instr
    n_bytes = sum(x.nbytes for x in instr) \
        + 2 * rows * n_regs * 15 * LIMB_BYTES
    n_mul = int(((msa != 0) | (msb != 0)).sum())
    n_lin = int(((lsa != 0) | (lsb != 0)).sum())
    n_ops = rows * (n_mul * WIDE_MACS_PER_MONT * IMAD_PER_WIDE_MAC
                    + n_lin * INT_OPS_PER_LIN)
    return n_bytes, n_ops, n_mul, n_lin


def _check_stream(torch, dev, rng, imad_rate, l2_ns, prog, rows, **labels):
    """One program's real instruction stream on ``rows`` rows of random
    canonical inputs, one launch each: the first CHECK_STEPS steps against
    the plain version on the whole register file (limb for limb, both
    timed), then the full stream timed."""
    from consensus_specs_tpu_torch.ops import cuda_step, vm

    instr = prog.device_instr(dev)
    stacked = _canonical_limbs(rng, (rows, len(prog.input_names)))
    regs0 = vm._init_regs(prog, stacked.astype(np.uint64), dev)
    head = tuple(x[:CHECK_STEPS] for x in instr)

    got = cuda_step.run_steps(regs0.clone(), head)
    want = regs0.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vm._run_steps_plain(want, head)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got - want).abs().max().item())
    _check(err == 0, f"{labels['stream']} ({labels['kind']}, {rows} rows): "
                     f"step kernel differs from plain over {CHECK_STEPS} "
                     f"steps: max |err| {err}")
    del got, want
    work = regs0
    head_ms = _cuda_ms(torch, lambda: cuda_step.run_steps(work, head), 5)
    full_ms = _cuda_ms(torch, lambda: cuda_step.run_steps(work, instr), 3)
    full = _stream_work(prog.instr, prog.n_regs, rows)
    part = _stream_work(tuple(x[:CHECK_STEPS] for x in prog.instr),
                        prog.n_regs, rows)
    return {
        **labels, "rows": rows, "steps": prog.n_steps, "n_regs": prog.n_regs,
        "check_steps": CHECK_STEPS, "max_abs_err": err,
        "head_ms": head_ms, "head_plain_ms": plain_ms,
        "head_bytes": part[0], "head_imad": part[1],
        **{f"head_{key}": v
           for key, v in _bound(part[0], part[1], imad_rate).items()},
        "ms": full_ms, "us_per_step": full_ms * 1e3 / prog.n_steps,
        "bytes": full[0], "imad": full[1], "mul_lanes": full[2],
        "lin_lanes": full[3], **_bound(full[0], full[1], imad_rate),
        "latency_floor_ms": prog.n_steps * l2_ns * 1e-6,
    }


def phase_streams(torch, dev, rng, imad_rate, l2_ns, streams=MAIN_STREAMS):
    """The main path's real instruction streams, each through
    _check_stream."""
    from consensus_specs_tpu_torch.ops import bls_backend

    out = []
    for label, kind, k, fold, rows in streams:
        prog, got_fold = bls_backend._program(kind, k, fold)
        out.append(_check_stream(torch, dev, rng, imad_rate, l2_ns, prog,
                                 rows, stream=label, kind=kind, k=k,
                                 fold=got_fold))
    return out


def _recording_launch_shapes(shapes):
    """Wraps for bls_backend._program and vm.execute (see _patched) that
    note, in ``shapes``, each program the step kernel is launched with,
    its row count and its (kind, k, fold): {(id, rows): (program, rows,
    name)}, in first-launch order. Every launch resolves its program
    through _program (a _FoldLayout) just before its vm.execute."""
    names = {}

    def program_wrap(fn):
        def named(kind, k=0, fold=None):
            prog, got_fold = fn(kind, k, fold)
            names[id(prog)] = (kind, k, got_fold)
            return prog, got_fold
        return named

    def execute_wrap(fn):
        def recorded(program, inputs, batch_shape=(), device=None):
            rows = int(np.prod(batch_shape)) if batch_shape else 1
            shapes.setdefault((id(program), rows), (program, rows, names.get(
                id(program), (f"steps{program.n_steps}", 0, 0))))
            return fn(program, inputs, batch_shape=batch_shape,
                      device=device)
        return recorded
    return program_wrap, execute_wrap


def phase_path_streams(torch, dev, rng, imad_rate, l2_ns, shapes_by_path,
                       checked):
    """Every (program, rows) that the paths in ``shapes_by_path`` launched
    the step kernel at, and that no earlier check covered (``checked``:
    the earlier streams' result dicts), through _check_stream."""
    done = {(r["kind"], r["k"], r["fold"], r["rows"]) for r in checked}
    todo = {}
    for path, shapes in shapes_by_path.items():
        for prog, rows, (kind, k, fold) in shapes.values():
            key = (kind, k, fold, rows)
            if key in done:
                continue
            todo.setdefault(key, [prog, rows, kind, k, fold, []])[5].append(
                path)
    return [_check_stream(torch, dev, rng, imad_rate, l2_ns, prog, rows,
                          stream=f"{kind} k{k} fold {fold}", kind=kind, k=k,
                          fold=fold, paths=paths)
            for prog, rows, kind, k, fold, paths in todo.values()]


def new_launch_shapes(shapes_by_path, path, checked):
    """The (program, rows) that ``path`` launched the step kernel at and
    that neither another path of ``shapes_by_path`` nor an earlier check
    (``checked``: the streams' result dicts) covered, as
    "kind k<k> fold <fold> x<rows>"; the last kernels phase holds them
    against the plain steps."""
    def keys(shapes):
        return {(kind, k, fold, rows)
                for _, rows, (kind, k, fold) in shapes.values()}

    seen = {(r["kind"], r["k"], r["fold"], r["rows"]) for r in checked}
    for other, shapes in shapes_by_path.items():
        if other != path:
            seen |= keys(shapes)
    return [f"{kind} k{k} fold {fold} x{rows}"
            for kind, k, fold, rows in sorted(keys(shapes_by_path[path]) - seen,
                                              key=str)]


def _bound(n_bytes, n_ops, imad_rate):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / imad_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# phase 3: one program, CUDA executor against the plain executor
# ---------------------------------------------------------------------------


def phase_program(torch, dev, rng):
    from consensus_specs_tpu_torch.ops import bls_backend, fq, vm

    prog, fold = bls_backend._program("hard_part_frobenius", 0, 1)
    rows = 2
    ins = {}
    for name in prog.input_names:
        ins[name] = np.stack([
            fq.to_mont_int(int(rng.integers(1, 1 << 62)) ** 6 % fq.P)
            for _ in range(rows)])
    t0 = time.perf_counter()
    got = vm.execute(prog, ins, batch_shape=(rows,), device=dev)
    cuda_s = time.perf_counter() - t0
    stacked = prog.stack_inputs(ins, (rows,))
    regs = vm._init_regs(prog, stacked, dev)
    t0 = time.perf_counter()
    vm._run_steps_plain(regs, prog.device_instr(dev))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    want = regs[:, torch.as_tensor(prog.output_regs.astype(np.int64),
                                   device=dev)].cpu().numpy()
    for i, name in enumerate(prog.output_names):
        _check(np.array_equal(got[name], want[:, i].astype(np.uint64)),
               f"program output {name} differs between executors")
    return {"phase": "program", "kind": "hard_part_frobenius", "fold": fold,
            "rows": rows, "steps": prog.n_steps, "n_regs": prog.n_regs,
            "outputs": len(prog.output_names), "exact": True,
            "cuda_s": cuda_s, "plain_s": plain_s}


# ---------------------------------------------------------------------------
# phase 4: the slice at mainnet size
# ---------------------------------------------------------------------------

N_COMMITTEES = 64
COMMITTEE = 146  # 300,000 validators / 32 slots / 64 committees
KEY_POOL = 512


def key_pool(seed=SEED, pool=KEY_POOL):
    """(rng, secret keys, compressed pubkeys) of a pool of distinct keys
    with small secret keys (index + 1) << 16 | salt, so SkToPk is a short
    double-and-add; ``rng`` is left where the slot's draws continue."""
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    rng = np.random.default_rng(seed)
    salt = int(rng.integers(0, 1 << 16))
    sks = [((i + 1) << 16) | salt for i in range(pool)]
    pks = [O.g1_to_bytes(O.ec_mul(O.G1_GEN, sk)) for sk in sks]
    return rng, sks, pks


def make_slot(seed=SEED, n_committees=N_COMMITTEES, committee=COMMITTEE,
              pool=KEY_POOL, plant=True, message_seed=None):
    """One slot's attestation aggregates: (pubkey_sets, messages,
    signatures, expected verdicts, planted {reason: index}); with
    ``plant=False`` the same slot with nothing planted (all valid); with
    ``message_seed`` a slot over the same key pool with its own members,
    messages and signatures (a later slot of the same validators).

    Members come from ``key_pool``; each aggregate is one signature by the
    committee's summed secret key (an aggregate of same-message signatures
    equals it)."""
    from consensus_specs_tpu_torch.ops.bls_backend import DST
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    rng, sks, pks = key_pool(seed, pool)
    if message_seed is not None:
        rng = np.random.default_rng(message_seed)
    members = [rng.choice(pool, committee, replace=False)
               for _ in range(n_committees)]
    messages = [rng.bytes(32) for _ in range(n_committees)]

    def sign(idx, msg):
        agg_sk = sum(sks[int(i)] for i in idx) % O.R
        return O.g2_to_bytes(O.ec_mul(O.hash_to_g2(msg, DST), agg_sk))

    pubkey_sets = [[pks[int(i)] for i in m] for m in members]
    signatures = [sign(m, msg) for m, msg in zip(members, messages)]
    expected = np.ones(n_committees, dtype=bool)
    if not plant:
        return pubkey_sets, messages, signatures, expected, {}
    planted = {"wrong_message": 5, "other_committee_signature": 17,
               "missing_member": 33, "malformed_signature": 50}
    i = planted["wrong_message"]
    messages[i] = rng.bytes(32)
    i = planted["other_committee_signature"]
    signatures[i] = signatures[i + 1]
    i = planted["missing_member"]
    pubkey_sets[i] = pubkey_sets[i][:-1]
    i = planted["malformed_signature"]
    signatures[i] = bytes([signatures[i][0] ^ 0x80]) + signatures[i][1:]
    for i in planted.values():
        expected[i] = False
    return pubkey_sets, messages, signatures, expected, planted


def oracle_verdict(pubkeys, message, signature):
    """FastAggregateVerify by the pure-int oracle: e(sum pk, H(m)) ==
    e(G1, sig) as one multi-pairing."""
    from consensus_specs_tpu_torch.ops.bls_backend import DST
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    try:
        sig = O.g2_from_bytes(signature)
        pts = [O.g1_from_bytes(pk) for pk in pubkeys]
    except ValueError:
        return False
    if sig is None or not pts or any(p is None for p in pts):
        return False
    agg = None
    for p in pts:
        agg = O.ec_add(agg, O.ec_from_affine(p))
    if agg is None:
        return False
    h = O.ec_to_affine(O.hash_to_g2(message, DST))
    neg_g1 = O.ec_to_affine(O.ec_neg(O.G1_GEN))
    f = O.multi_pairing([(O.ec_to_affine(agg), h), (neg_g1, sig)])
    return f == O.Fq12.one()


@contextlib.contextmanager
def _patched(module, name, wrap):
    """Replace module.name by wrap(original) for the duration."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _host_timer(sink):
    def wrap(fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sink.append(time.perf_counter() - t0)
        return timed
    return wrap


def _device_timer(torch, sink):
    def wrap(fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            sink.append(start.elapsed_time(end))
            return out
        return timed
    return wrap


def _verify_timed(torch, slot):
    """One batch_fast_aggregate_verify call on the card, with its wall time
    split into program assembly, the device stages (vm.execute: upload,
    steps, readback), the step kernels alone (CUDA events), the host easy
    part, and the rest of the host work (decode, subgroup checks,
    hash-to-G2, staging)."""
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_step, vm

    pubkey_sets, messages, signatures = slot
    asm, execs, easy, steps = [], [], [], []
    with _patched(bls_backend, "_program", _host_timer(asm)), \
            _patched(vm, "execute", _host_timer(execs)), \
            _patched(bls_backend, "_easy_part_batch", _host_timer(easy)), \
            _patched(cuda_step, "run_steps", _device_timer(torch, steps)):
        t0 = time.perf_counter()
        got = bls_backend.batch_fast_aggregate_verify(
            pubkey_sets, messages, signatures)
        wall = time.perf_counter() - t0
    split = {"wall_s": wall, "assemble_s": sum(asm),
             "vm_execute_s": sum(execs), "vm_executions": len(execs),
             "step_kernel_ms": sum(steps), "easy_part_s": sum(easy)}
    split["other_host_s"] = wall - split["assemble_s"] \
        - split["vm_execute_s"] - split["easy_part_s"]
    return got, split


def phase_slice(torch, card):
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_fq, cuda_step

    t0 = time.perf_counter()
    pubkey_sets, messages, signatures, expected, planted = make_slot()
    setup_s = time.perf_counter() - t0
    slot = (pubkey_sets, messages, signatures)

    cuda_step.LAUNCHES = 0
    cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = 0
    got, cold = _verify_timed(torch, slot)
    launches = {"vm_step": cuda_step.LAUNCHES, "mont_mul": cuda_fq.LAUNCHES,
                "vm_step_steps": cuda_step.STEPS}
    _check(list(got) == list(expected),
           f"verdicts {np.flatnonzero(~got).tolist()} false, planted "
           f"{sorted(planted.values())}")
    _check(launches["vm_step"] > 0, "the step kernel was never launched")
    _check(launches["vm_step"] == cold["vm_executions"],
           f"{launches['vm_step']} step-kernel launches for "
           f"{cold['vm_executions']} vm.execute calls (expected one each)")

    # warm: programs assembled, host caches filled
    warm_runs = []
    for _ in range(3):
        got2, warm = _verify_timed(torch, slot)
        _check(list(got2) == list(expected), "warm run verdicts differ")
        warm_runs.append(warm)
    warm = min(warm_runs, key=lambda r: r["wall_s"])

    checked = {}
    for i in (0, 1, planted["wrong_message"]):
        t0 = time.perf_counter()
        want = oracle_verdict(pubkey_sets[i], messages[i], signatures[i])
        _check(bool(got[i]) == want,
               f"item {i}: port says {bool(got[i])}, oracle {want}")
        checked[str(i)] = {"verdict": want,
                           "oracle_s": time.perf_counter() - t0}

    n = len(expected)
    return {
        "phase": "slice", "entry": "batch_fast_aggregate_verify",
        "committees": n, "committee_size": COMMITTEE,
        "k_bucket": bls_backend._k_bucket(COMMITTEE),
        "key_pool": KEY_POOL, "planted_invalid": planted,
        "verdicts_exact": True, "oracle_checked": checked,
        "setup_s": setup_s, "cold": cold, "warm_best_of_3": warm,
        "warm_wall_s_all": [r["wall_s"] for r in warm_runs],
        "verifications_per_s_warm": n / warm["wall_s"],
        "step_kernel_launches": launches["vm_step"],
        "step_kernel_steps": launches["vm_step_steps"],
        "mont_mul_kernel_launches": launches["mont_mul"], **card,
    }, launches, (slot, got, expected)


# ---------------------------------------------------------------------------
# phase 6: the RLC path at mainnet size
# ---------------------------------------------------------------------------


class _TimedLaunches:
    """Stands in for a kernel library: calls of its launch function
    ``name`` are bracketed by CUDA events, collected in ``sink`` as (start,
    end) pairs and summed once the run has synchronized (a wait per call
    would pace the launches). The events bracket the kernel alone, not the
    wrapper's copies and allocations around it."""

    def __init__(self, torch, lib, name, sink):
        self._torch, self._lib, self._name, self._sink = torch, lib, name, sink

    def __getattr__(self, attr):
        fn = getattr(self._lib, attr)
        if attr != self._name:
            return fn

        def timed(*args):
            if self._torch.cuda.is_current_stream_capturing():
                return fn(*args)  # recorded into a CUDA graph, not run
            start = self._torch.cuda.Event(enable_timing=True)
            end = self._torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self._sink.append((start, end))
            return rc
        return timed


def _rlc_timed(torch, items):
    """One batch_verify_rlc call on the card with a fixed
    random.Random(SEED) (the same scalars, so the same trajectory, on
    every run), its wall split as in _verify_timed (the easy part here is
    every _easy_part_flat: one per combined check and per singleton), its
    kernel counts from 0 and its RLC_STATS deltas."""
    from consensus_specs_tpu_torch.ops import (bls_backend, cuda_fq,
                                               cuda_step, vm)

    asm, execs, easy, steps, monts = [], [], [], [], []
    before = dict(bls_backend.RLC_STATS)
    cuda_step.LAUNCHES = cuda_step.STEPS = cuda_fq.LAUNCHES = 0
    with _patched(bls_backend, "_program", _host_timer(asm)), \
            _patched(vm, "execute", _host_timer(execs)), \
            _patched(bls_backend, "_easy_part_flat", _host_timer(easy)), \
            _patched(cuda_step, "run_steps", _device_timer(torch, steps)), \
            _patched(cuda_fq, "_lib", lambda lib: lambda: _TimedLaunches(
                torch, lib(), "mont_mul_launch", monts)):
        t0 = time.perf_counter()
        got = bls_backend.batch_verify_rlc(items, rng=random.Random(SEED))
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, n_steps, monts_n = (cuda_step.LAUNCHES, cuda_step.STEPS,
                                  cuda_fq.LAUNCHES)
    split = {"wall_s": wall, "assemble_s": sum(asm),
             "vm_execute_s": sum(execs), "vm_executions": len(execs),
             "step_kernel_ms": sum(steps), "easy_part_s": sum(easy),
             "easy_parts": len(easy),
             "mont_mul_kernel_ms": sum(s.elapsed_time(e) for s, e in monts),
             "step_kernel_launches": launches,
             "step_kernel_steps": n_steps,
             "mont_mul_kernel_launches": monts_n,
             "rlc_stats": {k: bls_backend.RLC_STATS[k] - before[k]
                           for k in before}}
    split["other_host_s"] = wall - split["assemble_s"] \
        - split["vm_execute_s"] - split["easy_part_s"]
    _check(launches == len(execs),
           f"{launches} step-kernel launches for {len(execs)} "
           "vm.execute calls (expected one each)")
    return got, split


def _rlc_warm(torch, items, want, label):
    runs = []
    for _ in range(3):
        got, run = _rlc_timed(torch, items)
        _check(list(got) == list(want), f"{label}: warm RLC verdicts differ")
        runs.append(run)
    return min(runs, key=lambda r: r["wall_s"]), [r["wall_s"] for r in runs]


def _per_item_warm(torch, slot):
    """The per-item path on the all-valid slot, warm, best of 3: the RLC
    all-valid slot's like-for-like comparison in the same call."""
    runs = []
    for _ in range(3):
        got, run = _verify_timed(torch, slot)
        _check(bool(got.all()), "per-item all-valid verdicts not all True")
        runs.append(run)
    return min(runs, key=lambda r: r["wall_s"]), [r["wall_s"] for r in runs]


_F_INPUT = re.compile(r"(^|\.)f\d+\.\d+$")


def _loose_head_check(torch, dev, rng, fs, bits, imad_rate):
    """The real rlc_combine call's register file (PROG A's f rows as the
    combine gets them, the scalar bits) through the first CHECK_STEPS
    steps: the step kernel against the plain version on the whole file,
    limb for limb, timed. Then the same with every f input replaced by a
    random loose value below 2^382 (the program's declared input bound;
    most are >= p), limb for limb."""
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_step, fq, vm
    from consensus_specs_tpu_torch.utils.bls12_381 import P

    lay, ins, n_chunks = bls_backend._rlc_combine_inputs(fs, bits)
    loose_ins = {
        name: (_rand_loose_limbs(rng, v.shape[:-1], bits=382).astype(np.uint64)
               if _F_INPUT.search(name) else v)
        for name, v in ins.items()}
    prog = lay.program
    instr = prog.device_instr(dev)
    head = tuple(x[:CHECK_STEPS] for x in instr)
    errs, at_or_above_p = {}, {}
    for label, named in (("real", ins), ("loose", loose_ins)):
        regs0 = vm._init_regs(prog, prog.stack_inputs(named, (lay.rows,)),
                              dev)
        got = cuda_step.run_steps(regs0.clone(), head)
        want = regs0.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vm._run_steps_plain(want, head)
        torch.cuda.synchronize()
        if label == "real":
            plain_ms = (time.perf_counter() - t0) * 1e3
            work = regs0.clone()
        errs[label] = int((got - want).abs().max().item())
        _check(errs[label] == 0,
               f"rlc_combine ({label} inputs): step kernel differs from "
               f"plain over {CHECK_STEPS} steps: max |err| {errs[label]}")
        at_or_above_p[label] = int(sum(
            fq.limbs_to_int(v[r]) >= P for name, v in named.items()
            if _F_INPUT.search(name) for r in range(lay.rows)))
    head_ms = _cuda_ms(torch, lambda: cuda_step.run_steps(work, head), 5)
    part = _stream_work(tuple(x[:CHECK_STEPS] for x in prog.instr),
                        prog.n_regs, lay.rows)
    return {"stream": "rlc_combine", "kind": "rlc_combine",
            "k": bls_backend._rlc_chunk(fs.shape[0]), "fold": lay.fold,
            "rows": lay.rows, "chunks": n_chunks, "steps": prog.n_steps,
            "n_regs": prog.n_regs, "check_steps": CHECK_STEPS,
            "f_inputs_at_or_above_p": at_or_above_p,
            "max_abs_err_by_inputs": errs, "max_abs_err": max(errs.values()),
            "head_ms": head_ms, "head_plain_ms": plain_ms,
            "head_bytes": part[0], "head_imad": part[1],
            **{f"head_{key}": v
               for key, v in _bound(part[0], part[1], imad_rate).items()}}


def _mont_mul_at(torch, dev, rng, imad_rate, batch):
    """Kernel 2 against its plain version at one of the tower combine's
    shapes (``batch`` + (15,) limbs: loose, below 2^382), limb for limb,
    both timed."""
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    a = torch.from_numpy(_rand_loose_limbs(rng, batch, bits=382)).to(dev)
    b = torch.from_numpy(_rand_loose_limbs(rng, batch, bits=382)).to(dev)
    got = cuda_fq.mont_mul(a, b)
    err = int((got - fq.mont_mul_plain(a, b)).abs().max().item())
    _check(err == 0, f"mont_mul kernel at {batch} differs from plain: "
                     f"max |err| {err}")
    m = int(np.prod(batch))
    n_bytes = 3 * m * 15 * LIMB_BYTES
    n_ops = m * WIDE_MACS_PER_MONT * IMAD_PER_WIDE_MAC
    return {"shape": list(batch), "products": m, "max_abs_err": err,
            "ms": _cuda_ms(torch, lambda: cuda_fq.mont_mul(a, b), 200),
            "plain_ms": _cuda_ms(torch, lambda: fq.mont_mul_plain(a, b), 10),
            "bytes": n_bytes, "imad": n_ops,
            **_bound(n_bytes, n_ops, imad_rate)}


def phase_rlc(torch, dev, rng, imad_rate, card, slice_run, slice_warm_s):
    from consensus_specs_tpu_torch.ops import bls_backend

    t0 = time.perf_counter()
    pubkey_sets, messages, signatures, valid, _ = make_slot(plant=False)
    setup_s = time.perf_counter() - t0
    items = [("fast_aggregate", p, m, s)
             for p, m, s in zip(pubkey_sets, messages, signatures)]
    n = len(items)

    # all-valid slot: cold (rlc_combine assembled), then warm
    got, cold = _rlc_timed(torch, items)
    _check(bool(got.all()), f"all-valid slot: RLC verdicts "
                            f"{np.flatnonzero(~got).tolist()} false")
    warm, warm_walls = _rlc_warm(torch, items, valid, "all-valid slot")
    for label, run in (("cold", cold), ("warm", warm)):
        st = run["rlc_stats"]
        _check((st["combines"], st["final_exps"], st["bisections"]) == (1, 1, 0),
               f"all-valid slot ({label}): {st}, expected 1 combine, 1 final "
               "exp, 0 bisections")
    per_item, per_item_walls = _per_item_warm(
        torch, (pubkey_sets, messages, signatures))
    valid_line = {"cold": cold, "warm_best_of_3": warm,
                  "warm_wall_s_all": warm_walls,
                  "verifications_per_s_warm": n / warm["wall_s"],
                  "per_item_warm_best_of_3": per_item,
                  "per_item_warm_wall_s_all": per_item_walls,
                  "speedup_over_per_item": per_item["wall_s"] / warm["wall_s"]}

    # the planted slot of phase 4: first call assembles the bisection's
    # smaller chunk programs
    (p_sets, p_msgs, p_sigs), slice_got, expected = slice_run
    p_items = [("fast_aggregate", p, m, s)
               for p, m, s in zip(p_sets, p_msgs, p_sigs)]
    got, p_cold = _rlc_timed(torch, p_items)
    _check(list(got) == list(expected) == list(slice_got),
           f"planted slot: RLC verdicts {np.flatnonzero(~got).tolist()} "
           f"false, per-item {np.flatnonzero(~slice_got).tolist()}")
    p_warm, p_walls = _rlc_warm(torch, p_items, expected, "planted slot")
    _check(p_warm["rlc_stats"] == p_cold["rlc_stats"],
           "planted slot: the bisection's trajectory differs between runs")
    planted_line = {"cold": p_cold, "warm_best_of_3": p_warm,
                    "warm_wall_s_all": p_walls,
                    "verifications_per_s_warm": n / p_warm["wall_s"]}

    # tower combine on the all-valid slot, warm once; its (fs, bits) then
    # go through the VM combine and the loose-input head check
    seen = []

    def capture(fn):
        def wrapped(fs, bits, device):
            out = fn(fs, bits, device)
            seen.append((fs.copy(), bits.copy(), out))
            return out
        return wrapped

    os.environ["CONSENSUS_SPECS_TPU_RLC_BACKEND"] = "jax"
    try:
        with _patched(bls_backend, "_rlc_combine_tower", capture):
            got, tower = _rlc_timed(torch, items)
    finally:
        os.environ.pop("CONSENSUS_SPECS_TPU_RLC_BACKEND", None)
    _check(bool(got.all()), "tower combine: verdicts not all True")
    _check(tower["mont_mul_kernel_launches"] > 0,
           "tower combine: the Montgomery kernel was never launched")
    _check(len(seen) == 1, f"tower combine ran {len(seen)} times, expected 1")
    fs, bits, tower_coeffs = seen[0]
    vm_coeffs = bls_backend._rlc_combine_vm(fs, bits, dev)
    _check(tower_coeffs == vm_coeffs,
           "tower combine differs from the VM combine on the same inputs")
    tower["equals_vm_combine"] = True

    head = _loose_head_check(torch, dev, rng, fs, bits, imad_rate)
    # kernel 2 at the tower combine's shapes: the 144 products of each
    # Fq12 product, and the compress of each reduction batch
    mont = [_mont_mul_at(torch, dev, rng, imad_rate, (n, 12, 12)),
            _mont_mul_at(torch, dev, rng, imad_rate, (n, 6))]

    return {
        "phase": "rlc", "entry": "batch_verify_rlc", "committees": n,
        "committee_size": COMMITTEE,
        "k_bucket": bls_backend._k_bucket(COMMITTEE),
        "rlc_chunk": bls_backend._rlc_chunk(n), "setup_s": setup_s,
        "all_valid": valid_line,
        "planted": planted_line, "tower": tower,
        "per_item_planted_warm_wall_s": slice_warm_s, **card,
    }, head, mont, {"rlc": warm, "tower": tower}


# ---------------------------------------------------------------------------
# phase 7: the batched input codec and fresh slots
# ---------------------------------------------------------------------------

# the codec's programs with the folds and rows that bls_backend._fold_for
# gives a slot's prep: 512 pubkeys (fold 4), 64 signatures (fold 8), 64
# messages (fold 4)
CODEC_STREAMS = (
    ("g1_subgroup", "g1_subgroup", 0, 4, 128),
    ("g2_subgroup", "g2_subgroup", 0, 8, 8),
    ("h2g_finish", "h2g_finish", 0, 4, 16),
)
FRESH_SEED = SEED + 1


def _norm(v):
    """A codec result on one footing: ValueErrors by message, limb
    payloads by bytes."""
    if isinstance(v, ValueError):
        return ("err", str(v))
    if isinstance(v, tuple):
        return ("ok", tuple(np.asarray(x).tobytes() for x in v))
    return ("ok", np.asarray(v).tobytes())


def _off_subgroup(group):
    """A point on the curve (G1) or the twist (G2) outside the order-r
    subgroup, compressed."""
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    x0 = 5
    while True:
        if group == 1:
            y = O.fq_sqrt((x0 ** 3 + 4) % O.P)
            aff = None if y is None else (O.Fq(x0), O.Fq(y))
            inside = O.is_in_g1_subgroup
        else:
            x = O.Fq2(x0, 1)
            y = (x * x * x + O.B_G2).sqrt()
            aff = None if y is None else (x, y)
            inside = O.is_in_g2_subgroup
        if aff is not None and not inside(O.ec_from_affine(aff)):
            return (O.g1_to_bytes if group == 1 else O.g2_to_bytes)(aff)
        x0 += 1


def _codec_inputs(pool_pks, fresh_sigs):
    """The slot's prep sizes with every kind of input the codec rejects:
    512 pubkeys (506 of the pool, a point outside G1, infinity, a
    corrupted infinity, x >= p, x off the curve, a short blob) and 64
    signatures (60 of the fresh slot, a point outside G2, infinity, x >=
    p, x off the curve)."""
    n_pk = len(pool_pks)
    inf1 = bytes([0xC0]) + b"\x00" * 47
    pks = list(pool_pks[: n_pk - 6]) + [
        _off_subgroup(1), inf1, inf1[:1] + b"\x01" + inf1[2:],
        bytes([0x9F]) + b"\xff" * 47, bytes([0x80]) + b"\x00" * 46 + b"\x05",
        pool_pks[0][:47]]
    inf2 = bytes([0xC0]) + b"\x00" * 95
    sigs = list(fresh_sigs[:-4]) + [
        _off_subgroup(2), inf2, bytes([0x9F]) + b"\xff" * 95,
        bytes([0x80]) + b"\x00" * 94 + b"\x07"]
    return pks, sigs


def _field_inputs(pks, sigs, msgs):
    """The tensors the codec's field functions get for these inputs, as
    numpy limbs: the padded x of the live G1 and G2 encodings, the padded
    SSWU draws of the messages."""
    from consensus_specs_tpu_torch.ops import bls_backend, codec

    _, _, raw, _ = codec._parse_g1(pks)
    x1 = codec.bytes_be_to_limbs(
        np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(-1, 48))
    x1 = np.where(codec._limbs_lt_const(x1, codec._P_LIMBS)[:, None], x1, 0)
    _, _, raw1, raw0, _ = codec._parse_g2(sigs)
    a1, a0 = (codec.bytes_be_to_limbs(
        np.frombuffer(b"".join(r), dtype=np.uint8).reshape(-1, 48))
        for r in (raw1, raw0))
    ok = codec._limbs_lt_const(a0, codec._P_LIMBS) & codec._limbs_lt_const(
        a1, codec._P_LIMBS)
    x2 = np.where(ok[:, None, None], np.stack([a0, a1], axis=1), 0)
    us = codec.hash_to_field_fq2_batch(msgs, 2, bls_backend.DST)
    u = np.concatenate([us[:, 0], us[:, 1]], axis=0)
    return (codec._pad_batch(x1), codec._pad_batch(x2), codec._pad_batch(u))


def _same_tensors(torch, got, want):
    if isinstance(got, tuple):
        return all(_same_tensors(torch, g, w) for g, w in zip(got, want))
    return torch.equal(got.cpu(), want)


def _codec_field_checks(torch, dev, rng, pks, sigs, msgs):
    """Each field function of the codec on the card against the plain
    tensor path on the CPU, limb for limb (ok flags equal), at the slot's
    prep sizes; launches of kernel 2 and both times per function."""
    from consensus_specs_tpu_torch.ops import codec, cuda_fq, fq

    cpu = torch.device("cpu")
    x1, x2, u = _field_inputs(pks, sigs, msgs)
    inv_in = _canonical_limbs(rng, (x1.shape[0],)).astype(np.uint64)
    inv_in[::97] = 0  # zero lanes: inv(0) == 0
    proj = _rand_loose_limbs(rng, (len(msgs), 3, 2), bits=382).astype(
        np.uint64)
    proj[3, 2] = 0  # Z == 0
    cases = [
        ("_g1_decode", codec._g1_decode, (x1,)),
        ("_g2_decode", codec._g2_decode, (x2,)),
        ("_sswu_map", codec._sswu_map, (u,)),
        ("_fq_batch_inverse", codec._fq_batch_inverse, (inv_in,)),
        ("_proj_to_affine", codec._proj_to_affine,
         (proj[:, 0], proj[:, 1], proj[:, 2])),
    ]
    out = {}
    for name, fn, arrays in cases:
        on_card = [fq.limbs_from_numpy(a, dev) for a in arrays]
        on_cpu = [fq.limbs_from_numpy(a, cpu) for a in arrays]
        torch.cuda.synchronize()
        launches = cuda_fq.LAUNCHES
        t0 = time.perf_counter()
        got = fn(*on_card)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = cuda_fq.LAUNCHES - launches
        t0 = time.perf_counter()
        want = fn(*on_cpu)
        cpu_s = time.perf_counter() - t0
        _check(_same_tensors(torch, got, want),
               f"codec {name} on the card differs from the plain CPU path")
        out[name] = {"rows": int(arrays[0].shape[0]), "exact": True,
                     "mont_mul_launches": launches, "card_s": card_s,
                     "plain_cpu_s": cpu_s}
    return out


def _chain_checks(torch, dev, rng, imad_rate):
    """fq.pow_fixed's two routes on the card at the codec's chain shapes:
    step by step (one wrapper call and launch a product) and one replay of
    the chain's CUDA graph, limb for limb equal; the host time of each
    (synchronized), the replay's device time (CUDA events) and the
    chain's bound."""
    from consensus_specs_tpu_torch.ops import codec, cuda_fq, fq

    out = []
    for rows, label, bits in ((512, "sqrt", codec._SQRT_BITS),
                              (128, "sqrt", codec._SQRT_BITS),
                              (64, "sqrt", codec._SQRT_BITS),
                              (None, "inv", fq._P_MINUS_2_BITS)):
        shape = (rows,) if rows else ()
        a = torch.from_numpy(_canonical_limbs(rng, shape)).to(dev)
        fq.pow_fixed(a, bits)  # the key's first call captures the graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = fq.pow_fixed_steps(a, bits)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        launches = cuda_fq.LAUNCHES
        t0 = time.perf_counter()
        graph = fq.pow_fixed(a, bits)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        launches = cuda_fq.LAUNCHES - launches
        _check(torch.equal(steps, graph),
               f"pow_fixed ({label}, {rows} rows): graph replay differs from "
               "the step-by-step chain")
        _check(launches == 2 * (len(bits) - 1),
               f"pow_fixed replay counted {launches} launches")
        m = rows or 1
        n_ops = launches * m * WIDE_MACS_PER_MONT * IMAD_PER_WIDE_MAC
        out.append({
            "chain": label, "rows": m, "products": launches,
            "exact": True, "steps_host_s": steps_s, "graph_host_s": graph_s,
            "graph_device_ms": _cuda_ms(torch, lambda: fq.pow_fixed(a, bits),
                                        5),
            **_bound(2 * m * 15 * LIMB_BYTES, n_ops, imad_rate)})
    return out


def _codec_public_checks(torch, dev, pks, sigs, msgs):
    """The backend-facing batch codecs on the card (tensor path: kernel 2
    and the subgroup / hash-finish programs on kernel 1) against the
    raw-int host path, item for item (ValueError for ValueError), timed."""
    from consensus_specs_tpu_torch.ops import bls_backend, codec

    cases = [
        ("pubkey_limbs_batch", codec.pubkey_limbs_batch, pks),
        ("signature_limbs_batch", codec.signature_limbs_batch, sigs),
        ("message_limbs_batch",
         lambda xs, device: codec.message_limbs_batch(
             xs, bls_backend.DST, device), msgs),
    ]
    out = {}
    for name, fn, items in cases:
        t0 = time.perf_counter()
        got = [_norm(v) for v in fn(items, device=dev)]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [_norm(v) for v in fn(items, device="cpu")]
        host_s = time.perf_counter() - t0
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        _check(not bad, f"codec {name}: items {bad[:8]} differ between the "
                        "card and the host path")
        errors = sorted({w[1] for w in want if w[0] == "err"})
        out[name] = {"items": len(items), "equal_to_host_path": True,
                     "rejections": errors, "card_s": card_s,
                     "host_path_s": host_s}
    _check(any("subgroup" in e for e in out["pubkey_limbs_batch"]["rejections"])
           and any("subgroup" in e
                   for e in out["signature_limbs_batch"]["rejections"]),
           "codec checks: a non-subgroup point was not rejected")
    return out


def _evict(slot):
    """Drop a slot's messages and signatures from the limb caches, so its
    next run prepares them anew (a fresh slot: pubkeys stay cached)."""
    from consensus_specs_tpu_torch.ops import bls_backend

    _, messages, signatures = slot
    for m in messages:
        bls_backend._MSG_CACHE.pop(bytes(m), None)
    for s in signatures:
        bls_backend._SIG_CACHE.pop(bytes(s), None)


def _split_run(torch, call):
    """Run ``call()`` with the kernel counts from 0 and its wall split into
    codec prep (decode, subgroup checks, hash to G2, the prep's own
    vm.execute and kernel launches), per-item prep, program assembly, the
    other vm.execute calls, the step kernels (CUDA events), the host easy
    part (every _easy_part_flat), the RLC host fold (the rlc_combine call
    less its vm.execute and program assembly: the host products of the
    chunk results) and the rest. A service's stage threads are covered
    too: the patches are module-wide and the prep and fold nesting is
    tracked per thread."""
    import threading

    from consensus_specs_tpu_torch.ops import (bls_backend, codec, cuda_fq,
                                               cuda_step, vm)

    keys = ("prep", "decode", "subgroup", "hash", "per_item", "assemble",
            "assemble_fold", "execute", "execute_prep", "execute_fold",
            "easy", "fold", "scalars", "steps")
    sinks = {k: [] for k in keys}
    ctx = threading.local()
    prep_launches = {"vm_step": 0, "mont_mul": 0}
    lock = threading.Lock()

    def scoped(name, sink):
        def wrap(fn):
            def wrapped(*args, **kwargs):
                outer = getattr(ctx, name, False)
                setattr(ctx, name, True)
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    if not outer:
                        sinks[sink].append(time.perf_counter() - t0)
                    setattr(ctx, name, outer)
            return wrapped
        return wrap

    def prep_wrap(fn):
        timed = scoped("prep", "prep")(fn)

        def wrapped(*args, **kwargs):
            step0, mont0 = cuda_step.LAUNCHES, cuda_fq.LAUNCHES
            try:
                return timed(*args, **kwargs)
            finally:
                # the counters' growth over the prep (beside a service's
                # device stage, an upper bound)
                with lock:
                    prep_launches["vm_step"] += cuda_step.LAUNCHES - step0
                    prep_launches["mont_mul"] += cuda_fq.LAUNCHES - mont0
        return wrapped

    def exec_wrap(fn):
        def wrapped(*args, **kwargs):
            sink = ("execute_prep" if getattr(ctx, "prep", False) else
                    "execute_fold" if getattr(ctx, "fold", False) else
                    "execute")
            return _host_timer(sinks[sink])(fn)(*args, **kwargs)
        return wrapped

    def asm_wrap(fn):
        def wrapped(*args, **kwargs):
            sink = sinks["assemble_fold" if getattr(ctx, "fold", False)
                         else "assemble"]
            return _host_timer(sink)(fn)(*args, **kwargs)
        return wrapped

    patches = [
        (bls_backend, "prewarm_host_caches", prep_wrap),
        (codec, "decompress_g1_batch", _host_timer(sinks["decode"])),
        (codec, "decompress_g2_batch", _host_timer(sinks["decode"])),
        (codec, "g1_subgroup_check_batch", _host_timer(sinks["subgroup"])),
        (codec, "g2_subgroup_check_batch", _host_timer(sinks["subgroup"])),
        (codec, "hash_to_g2_batch", _host_timer(sinks["hash"])),
        (bls_backend, "_pubkey_limbs_compute", _host_timer(sinks["per_item"])),
        (bls_backend, "_signature_limbs_compute",
         _host_timer(sinks["per_item"])),
        (bls_backend, "_message_limbs_compute",
         _host_timer(sinks["per_item"])),
        (bls_backend, "_program", asm_wrap),
        (vm, "execute", exec_wrap),
        (bls_backend, "_easy_part_flat", _host_timer(sinks["easy"])),
        (bls_backend, "_rlc_combine_vm", scoped("fold", "fold")),
        (bls_backend, "_rlc_scalars", _host_timer(sinks["scalars"])),
        (cuda_step, "run_steps", _device_timer(torch, sinks["steps"])),
    ]
    rlc0 = dict(bls_backend.RLC_STATS)
    calls0 = dict(bls_backend.CALL_COUNTS)
    prep0 = dict(bls_backend.PREP_STATS)
    cuda_step.LAUNCHES = cuda_step.STEPS = cuda_fq.LAUNCHES = 0
    with contextlib.ExitStack() as stack:
        for module, name, wrap in patches:
            stack.enter_context(_patched(module, name, wrap))
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, n_steps, monts = (cuda_step.LAUNCHES, cuda_step.STEPS,
                                cuda_fq.LAUNCHES)
    total = {k: sum(v) for k, v in sinks.items()}
    split = {
        "wall_s": wall, "codec_prep_s": total["prep"],
        "codec_decode_s": total["decode"],
        "codec_subgroup_s": total["subgroup"], "codec_hash_s": total["hash"],
        "codec_vm_execute_s": total["execute_prep"],
        "per_item_prep_s": total["per_item"],
        "per_item_prep_calls": len(sinks["per_item"]),
        "assemble_s": total["assemble"] + total["assemble_fold"],
        "vm_execute_s": total["execute"] + total["execute_fold"],
        "step_kernel_ms": total["steps"], "easy_part_s": total["easy"],
        "rlc_host_fold_s": (total["fold"] - total["execute_fold"]
                            - total["assemble_fold"]),
        "rlc_combine_vm_execute_s": total["execute_fold"],  # in the above
        "rlc_scalars_s": total["scalars"],
        "vm_executions": sum(len(sinks[k]) for k in (
            "execute", "execute_prep", "execute_fold")),
        "step_kernel_launches": launches, "step_kernel_steps": n_steps,
        "mont_mul_kernel_launches": monts,
        "prep_step_kernel_launches": prep_launches["vm_step"],
        "prep_mont_mul_kernel_launches": prep_launches["mont_mul"],
        "rlc_stats": {k: bls_backend.RLC_STATS[k] - rlc0[k] for k in rlc0},
        "call_counts": {k: bls_backend.CALL_COUNTS[k] - calls0[k]
                        for k in calls0},
        "prep_stats": {k: bls_backend.PREP_STATS[k] - prep0[k]
                       for k in prep0},
    }
    # the service's stages overlap, so only a direct call's parts add up
    split["other_host_s"] = wall - total["prep"] - total["assemble"] \
        - total["execute"] - total["easy"] - total["fold"] \
        - total["scalars"]
    _check(launches == split["vm_executions"],
           f"{launches} step-kernel launches for "
           f"{split['vm_executions']} vm.execute calls (expected one each)")
    return got, split


def _fresh_timed(torch, entry, slot):
    """One call of ``entry`` on the slot, evicted first, split by
    _split_run."""
    from consensus_specs_tpu_torch.ops import bls_backend

    _evict(slot)
    pubkey_sets, messages, signatures = slot
    if entry == "batch_verify_rlc":
        return _split_run(torch, lambda: bls_backend.batch_verify_rlc(
            [("fast_aggregate", p, m, s)
             for p, m, s in zip(pubkey_sets, messages, signatures)],
            rng=random.Random(SEED)))
    return _split_run(torch, lambda: bls_backend.batch_fast_aggregate_verify(
        pubkey_sets, messages, signatures))


def _prep_kernel2_ms(torch, slot):
    """Kernel 2's device time inside one codec prep of the evicted slot's
    messages and signatures (an instrumented run, apart from the timed
    walls): CUDA events around each wrapper launch, and around each chain
    replay (the graph's launches plus its input copy and output clone)."""
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_fq

    _evict(slot)
    single, chains = [], []

    def timed_chain(fn):
        def wrapped(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            chains.append((start, end))
            return out
        return wrapped

    launches = cuda_fq.LAUNCHES
    with _patched(cuda_fq, "_lib", lambda lib: lambda: _TimedLaunches(
            torch, lib(), "mont_mul_launch", single)), \
            _patched(cuda_fq, "pow_chain", timed_chain):
        t0 = time.perf_counter()
        bls_backend.prewarm_host_caches(slot[1], slot[2])
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    ms = lambda evs: sum(s.elapsed_time(e) for s, e in evs)
    return {"wall_s": wall, "launches": cuda_fq.LAUNCHES - launches,
            "single_launches": len(single), "single_ms": ms(single),
            "chain_replays": len(chains), "chain_ms": ms(chains)}


def _cold_pubkeys(torch, pool_pks):
    """The pool's pubkeys dropped from the cache and prepared again: by the
    codec on the card (one prewarm), then per item by the oracle."""
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_fq, cuda_step

    out = {"pubkeys": len(pool_pks)}
    for label in ("codec", "per_item"):
        for pk in pool_pks:
            bls_backend._PK_CACHE.pop(pk, None)
        step0, mont0 = cuda_step.LAUNCHES, cuda_fq.LAUNCHES
        t0 = time.perf_counter()
        if label == "codec":
            bls_backend.prewarm_host_caches([], [], pool_pks)
        else:
            for pk in pool_pks:
                bls_backend._pubkey_limbs(pk)
        torch.cuda.synchronize()
        out[label] = {"s": time.perf_counter() - t0,
                      "step_kernel_launches": cuda_step.LAUNCHES - step0,
                      "mont_mul_kernel_launches": cuda_fq.LAUNCHES - mont0}
    _check(all(pk in bls_backend._PK_CACHE for pk in pool_pks),
           "cold pubkeys: the pool is not cached after its prep")
    return out


def _single_item_prep(torch, slot):
    """n = 1: one fresh message and signature prepared by the codec on the
    card (the first such call captures the chains at the new shapes, the
    next one replays them), then per item by the oracle."""
    from consensus_specs_tpu_torch.ops import bls_backend

    out = {}
    for label, i in (("codec_first", 0), ("codec", 1), ("per_item", 1)):
        one = ([slot[0][i]], [slot[1][i]], [slot[2][i]])
        _evict(one)
        t0 = time.perf_counter()
        if label.startswith("codec"):
            bls_backend.prewarm_host_caches(one[1], one[2])
        else:
            bls_backend._message_limbs(bytes(one[1][0]))
            bls_backend._signature_limbs(bytes(one[2][0]))
        torch.cuda.synchronize()
        out[label + "_s"] = time.perf_counter() - t0
    return out


def phase_codec(torch, dev, rng, imad_rate, l2_ns, card):
    """The batched input codec on the card: its field functions against
    the plain CPU path and its batch entry points against the host path at
    a slot's prep sizes, its three programs on kernel 1 (first 256 steps
    exact, whole streams timed), kernel 2 at its shapes, then fresh slots
    (new messages and signatures, pubkeys cached) through both entry
    points with the codec and with per-item prep."""
    from consensus_specs_tpu_torch.ops import bls_backend, fq

    t0 = time.perf_counter()
    pubkey_sets, messages, signatures, expected, planted = make_slot(
        message_seed=FRESH_SEED)
    _, _, pool_pks = key_pool()
    setup_s = time.perf_counter() - t0
    slot = (pubkey_sets, messages, signatures)
    _check(all(pk in bls_backend._PK_CACHE for pk in pool_pks),
           "fresh slot: the key pool is not cached from phase 4")

    pks, sigs = _codec_inputs(pool_pks, signatures)
    field = _codec_field_checks(torch, dev, rng, pks, sigs, messages)
    public = _codec_public_checks(torch, dev, pks, sigs, messages)
    streams = phase_streams(torch, dev, rng, imad_rate, l2_ns,
                            streams=CODEC_STREAMS)
    mont = [_mont_mul_at(torch, dev, rng, imad_rate, (n,))
            for n in (512, 128, 64)]

    chains = _chain_checks(torch, dev, rng, imad_rate)

    runs, paths = {}, {}
    for entry, prep in (("batch_fast_aggregate_verify", "codec"),
                        ("batch_fast_aggregate_verify", "codec_chain_steps"),
                        ("batch_fast_aggregate_verify", "per_item"),
                        ("batch_verify_rlc", "codec"),
                        ("batch_verify_rlc", "per_item")):
        if prep == "per_item":
            os.environ["CONSENSUS_SPECS_TPU_BATCH_CODEC"] = "0"
        # codec_chain_steps: the same codec with every chain run step by
        # step instead of replayed, for the graph's gain in this call
        steps = prep == "codec_chain_steps"
        try:
            with _patched(fq, "pow_fixed", lambda real: (
                    fq.pow_fixed_steps if steps else real)):
                got, run = _fresh_timed(torch, entry, slot)
        finally:
            os.environ.pop("CONSENSUS_SPECS_TPU_BATCH_CODEC", None)
        _check(list(got) == list(expected),
               f"fresh slot, {entry}, {prep} prep: verdicts "
               f"{np.flatnonzero(~got).tolist()} false, planted "
               f"{sorted(planted.values())}")
        if prep == "codec":
            _check(run["prep_mont_mul_kernel_launches"] > 0
                   and run["prep_step_kernel_launches"] > 0,
                   f"fresh slot, {entry}: the codec prep launched no kernel")
            paths["codec" if entry == "batch_fast_aggregate_verify"
                  else "codec_rlc"] = run
        runs[f"{entry}.{prep}"] = run
    for entry in ("batch_fast_aggregate_verify", "batch_verify_rlc"):
        runs[entry + ".prep_speedup"] = (
            runs[entry + ".per_item"]["per_item_prep_s"]
            / runs[entry + ".codec"]["codec_prep_s"])
    runs["chain_graph_prep_speedup"] = (
        runs["batch_fast_aggregate_verify.codec_chain_steps"]["codec_prep_s"]
        / runs["batch_fast_aggregate_verify.codec"]["codec_prep_s"])
    kernel2 = _prep_kernel2_ms(torch, slot)
    cold_pks = _cold_pubkeys(torch, pool_pks)
    single = _single_item_prep(torch, slot)
    return {
        "phase": "codec", "setup_s": setup_s,
        "fresh_slot": {"committees": len(expected),
                       "committee_size": COMMITTEE, "key_pool": KEY_POOL,
                       "planted_invalid": planted, "verdicts_exact": True},
        "field_functions": field, "batch_codecs": public, "chains": chains,
        "fresh": runs, "prep_kernel2": kernel2, "cold_pubkeys": cold_pks,
        "single_item": single, **card,
    }, streams, mont, paths


# ---------------------------------------------------------------------------
# phase 8: the serve plane
# ---------------------------------------------------------------------------

SERVE_SEED = SEED + 2  # the serve slot's members, messages and signatures
# the JAX package's serve bench knobs (serve/load.py run_serve_bench)
SERVE_EVENTS = 256
SERVE_RATE_HZ = 256.0
SERVE_MAX_BATCH = 32
SERVE_MAX_WAIT_MS = 20.0
# the fault-injection stream: the JAX serve bench's defaults, which the
# port's serve/load.run_serve_bench keeps (k sizes the warm programs)
FAULT_K = 8
_ENTRIES = ("batch_verify_rlc", "batch_fast_aggregate_verify",
            "batch_aggregate_verify", "prewarm_host_caches")


class _CallLog:
    """A backend (the port's module, or a proxy of it) with every entry
    call logged as [entry, items, traceback or None], so a fault that the
    service's ladder absorbs is still reported."""

    def __init__(self, backend):
        self._backend = backend
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._backend, name)
        if name not in _ENTRIES:
            return fn

        def call(*args, **kwargs):
            rec = [name, len(args[0]) if args else 0, None]
            self.calls.append(rec)
            try:
                return fn(*args, **kwargs)
            except Exception:
                import traceback

                rec[2] = traceback.format_exc()[-1500:]
                raise
        return call

    def errors(self):
        return [c for c in self.calls if c[2] is not None]


def _warm_programs(ks):
    """Assemble every program a flush of 1 to 32 items can resolve, outside
    the timed streams (the serve bench's warm-up): PROG A for each k bucket
    at folds 1-8, the combine chunks 2-16, the device hard part at folds
    1-8 and the codec's signature and hash programs."""
    from consensus_specs_tpu_torch.ops import bls_backend

    t0 = time.perf_counter()
    wanted = [("miller_product", k, f) for k in ks for f in (1, 2, 4, 8)]
    wanted += [("rlc_combine", c, 1) for c in (2, 4, 8, 16)]
    wanted += [("hard_part_frobenius", 0, f) for f in (1, 2, 4, 8)]
    wanted += [("g2_subgroup", 0, f) for f in (1, 2, 4, 8)]
    wanted += [("h2g_finish", 0, f) for f in (1, 2, 4)]
    for kind, k, fold in wanted:
        bls_backend._program(kind, k, fold=fold)
    return {"programs": len(wanted), "s": time.perf_counter() - t0}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_s(xs, ys):
    """Seconds covered by both interval sets."""
    xs, ys = _union(xs), _union(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _serve_stream(torch, backend, committees, rng, picks):
    """The serve bench's stream (serve/load.py run_serve_bench) through the
    port's VerificationService on the card: one submit per pick at Poisson
    gaps from ``rng``, every future awaited. Returns (service, verdicts,
    expected, elapsed_s, signatures submitted, device-stage intervals)."""
    import concurrent.futures as cf

    from consensus_specs_tpu_torch.serve import VerificationService

    svc = VerificationService(backend=backend, max_batch=SERVE_MAX_BATCH,
                              max_wait_ms=SERVE_MAX_WAIT_MS)
    stage = []
    process = svc._process

    def timed_process(batch):
        t0 = time.perf_counter()
        try:
            return process(batch)
        finally:
            stage.append((t0, time.perf_counter()))
    svc._process = timed_process
    try:
        futures, expected, sig_count = [], [], 0
        t_start = time.perf_counter()
        t_next = t_start
        for ci in picks:
            pks, msg, sig, ok = committees[ci]
            futures.append(svc.submit("fast_aggregate", pks, msg, sig))
            expected.append(bool(ok))
            sig_count += len(pks)
            t_next += rng.expovariate(SERVE_RATE_HZ)
            pause = t_next - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
        _, pending = cf.wait(futures, timeout=600)
        elapsed = time.perf_counter() - t_start
    finally:
        svc.close(timeout=120)
    torch.cuda.synchronize()
    _check(not pending, f"serve stream: {len(pending)} of {len(futures)} "
                        "requests never resolved")
    got = [bool(f.result()) for f in futures]
    return svc, got, expected, elapsed, sig_count, (t_start, stage)


_LADDER = ("serve.prep_error", "serve.rlc_error", "serve.backend_error",
           "serve.device_stage_error")


def _ladder_records():
    from consensus_specs_tpu_torch.ops import profiling

    summ = profiling.summary()
    return {label: summ.get(label, {}).get("calls", 0) for label in _LADDER}


def _serve_main(torch):
    """The main stream: a new slot of phase 4's key pool heard four times
    over through the service, no injected fault."""
    from consensus_specs_tpu_torch.obs import devices
    from consensus_specs_tpu_torch.obs import programs as obs_programs
    from consensus_specs_tpu_torch.ops import (bls_backend, cuda_fq,
                                               cuda_step, profiling)
    from consensus_specs_tpu_torch.serve import load

    t0 = time.perf_counter()
    pubkey_sets, messages, signatures, expected, planted = make_slot(
        message_seed=SERVE_SEED)
    committees = list(zip(pubkey_sets, messages, signatures, expected))
    rng = random.Random(SEED)
    picks = load._event_schedule(rng, committees, SERVE_EVENTS)
    distinct = sorted(set(picks))
    setup_s = time.perf_counter() - t0
    warm = _warm_programs((bls_backend._k_bucket(COMMITTEE), FAULT_K))
    # the bench's warm-up: one committee outside the stream (the slot's
    # unheard committee, or the first when every one is heard)
    spare = ([i for i in range(len(committees)) if i not in set(picks)]
             or [0])[0]
    t0 = time.perf_counter()
    warm_ok = bls_backend.batch_fast_aggregate_verify(
        [pubkey_sets[spare]], [messages[spare]], [signatures[spare]])
    warm["warmup_verify_s"] = time.perf_counter() - t0
    _check(bool(warm_ok[0]) == bool(expected[spare]),
           "serve warm-up: wrong verdict")

    profiling.reset()
    obs_programs.export_gauges()
    devices.reset_global()
    bls_backend.reset_call_counts()
    bls_backend.reset_prep_state()
    log = _CallLog(bls_backend)
    cuda_step.LAUNCHES = cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = cuda_fq.CAPTURES = 0
    svc, got, want, elapsed, sig_count, (t_start, stage) = _serve_stream(
        torch, log, committees, rng, picks)
    launches = {"vm_step": cuda_step.LAUNCHES,
                "vm_step_steps": cuda_step.STEPS,
                "mont_mul": cuda_fq.LAUNCHES}
    captures = cuda_fq.CAPTURES

    wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    _check(not wrong, f"serve stream: events {wrong[:10]} answered wrong")
    _check(not log.errors(), "serve stream: backend calls raised:\n"
           + "\n".join(e[2] for e in log.errors()[:2]))
    snap = svc.metrics.snapshot()
    ladder = _ladder_records()
    for key in ("fallback_items", "backend_retries", "mesh_fallbacks"):
        _check(snap[key] == 0, f"serve stream: {key} = {snap[key]}")
    _check(not any(ladder.values()), f"serve stream: ladder records {ladder}")
    prep = dict(bls_backend.PREP_STATS)
    _check(prep["codec_batches"] > 0 and prep["serial_fallback_items"] == 0,
           f"serve stream: prep {prep}, expected codec batches only")
    calls = dict(bls_backend.CALL_COUNTS)
    _check(calls["items"] == len(distinct),
           f"serve stream: {calls['items']} items reached the backend for "
           f"{len(distinct)} distinct checks")
    _check(captures > 0, "serve stream: no chain graph was captured")
    _check(launches["vm_step"] > 0 and launches["mont_mul"] > 0,
           f"serve stream: kernel launches {launches}")

    ledger = devices.global_ledger()
    lanes = ledger.snapshot()["lanes"]
    card_lane = str(torch.cuda.current_device())
    timeline = ledger.timeline()
    t_end = t_start + elapsed

    def clip(iv):
        return [(max(a, t_start), min(b, t_end)) for a, b in iv
                if b > t_start and a < t_end]
    host_iv = clip([(a, b) for lane, _, a, b in timeline
                    if lane == devices.HOST_LANE])
    card_iv = clip([(a, b) for lane, _, a, b in timeline
                    if lane == card_lane])
    stage_iv = clip(stage)
    verified_keys = sum(len(pubkey_sets[i]) for i in distinct)
    lat = snap["latency"]
    line = {
        "committees": len(committees), "committee_size": COMMITTEE,
        "events": len(picks), "distinct_checks": len(distinct),
        "rate_hz": SERVE_RATE_HZ, "max_batch": SERVE_MAX_BATCH,
        "max_wait_ms": SERVE_MAX_WAIT_MS, "planted_invalid": planted,
        "verdicts_exact": True, "setup_s": setup_s, "warm": warm,
        "elapsed_s": elapsed,
        "served_sigs_per_s": sig_count / elapsed,
        "verified_sigs_per_s": verified_keys / elapsed,
        "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
        "p99_ms": lat.get("p99_ms"), "latency_n": lat.get("n"),
        "flushes": snap["device_flushes"], "batches": snap["batches"],
        "occupancy_rows": snap["occupancy_rows"],
        "occupancy_lanes": snap["occupancy_lanes"],
        "cache_hit_rate": snap["cache_hit_rate"],
        "cache_hits": snap["cache_hits"],
        "inflight_joins": snap["inflight_joins"],
        "prep_ms_per_flush": snap["prep_ms_per_flush"],
        "device_ms_per_flush": snap["device_ms_per_flush"],
        "final_exps_per_item": snap["final_exps_per_item"],
        "rlc": snap["rlc"], "prep": prep, "call_counts": calls,
        "fallback_items": snap["fallback_items"],
        "backend_retries": snap["backend_retries"],
        "mesh_fallbacks": snap["mesh_fallbacks"], "ladder_records": ladder,
        "step_kernel_launches": launches["vm_step"],
        "step_kernel_steps": launches["vm_step_steps"],
        "mont_mul_kernel_launches": launches["mont_mul"],
        "chain_graph_captures": captures,
        "card_lane_busy_s": lanes.get(card_lane, {}).get("busy_s", 0.0),
        "host_lane_busy_s": lanes.get(devices.HOST_LANE, {}).get(
            "busy_s", 0.0),
        # the two ledger lanes overlap (the card lane holds the prep's
        # own codec programs too), and the prep stage against the device
        # stage proper: the pipeline's overlap
        "lane_overlap_share": _overlap_s(host_iv, card_iv) / elapsed,
        "stage_overlap_share": _overlap_s(host_iv, stage_iv) / elapsed,
        "device_stage_busy_share": sum(
            b - a for a, b in _union(stage_iv)) / elapsed,
    }
    verdict_by_committee = {ci: g for ci, g in zip(picks, got)}
    return line, launches, committees, distinct, verdict_by_committee


def _serve_offline(torch, committees, distinct, stream_verdicts):
    """The stream's distinct checks through one batch_verify_rlc call,
    warm (every input cached by the stream), best of 2 after a first
    call: the offline floor of the same work."""
    from consensus_specs_tpu_torch.ops import bls_backend

    items = [("fast_aggregate",) + tuple(committees[ci][:3])
             for ci in distinct]
    want = [stream_verdicts[ci] for ci in distinct]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = bls_backend.batch_verify_rlc(items, rng=random.Random(SEED))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        _check([bool(g) for g in got] == want,
               "offline floor: verdicts differ from the stream's")
    best = min(walls[1:])
    keys = sum(len(committees[ci][0]) for ci in distinct)
    return {"items": len(items), "wall_s": best, "wall_s_all": walls,
            "verified_sigs_per_s": keys / best, "verdicts_equal": True}


def _serve_fault(torch, fail_calls):
    """The JAX serve bench's fault-injection stream, driven through the
    port's own serve/load.run_serve_bench on the card at its defaults (8
    committees of 8, 64 events at 256 Hz, the last committee corrupt),
    behind FailingBackendProxy with ``fail_calls``: the ladder working on
    purpose. Every verdict must be right and later flushes must reach the
    backend; the poisoned (first) flush goes to the per-group path when
    calls 1-2 fail, and on to the oracle when calls 1-4 fail, where the
    service must journal it and warn even with the flight recorder
    off."""
    import warnings

    from consensus_specs_tpu_torch.obs import flight
    from consensus_specs_tpu_torch.ops import bls_backend
    from consensus_specs_tpu_torch.serve import load

    made = []

    def logged_proxy(real):
        def make(backend):
            proxy = real(backend, fail_calls=fail_calls)
            made.append((proxy, _CallLog(proxy)))
            return made[-1][1]
        return make

    bls_backend.reset_call_counts()
    flight.reset_global()
    with warnings.catch_warnings(record=True) as caught, \
            _patched(load, "FailingBackendProxy", logged_proxy):
        warnings.simplefilter("always")
        rec = load.run_serve_bench()
    torch.cuda.synchronize()
    _check(len(made) == 1, f"fault stream {fail_calls}: {len(made)} proxies")
    proxy, log = made[0]
    oracle_warnings = [w for w in caught
                       if "pure-Python oracle" in str(w.message)]
    oracle_notes = [e for e in flight.global_recorder().events()
                    if e["kind"] in ("degraded_to_oracle",
                                     "device_stage_error")]
    flight.reset_global()
    _check(rec["lost"] == 0 and rec["wrong"] == 0 and rec["fault_injected"],
           f"fault stream {fail_calls}: lost {rec['lost']}, wrong "
           f"{rec['wrong']}, injected {rec['fault_injected']}")
    ladder = {label: rec["profile"].get(label, {}).get("calls", 0)
              for label in _LADDER}
    verify = [c for c in log.calls if c[0] != "prewarm_host_caches"]
    poisoned = verify[0][1]
    injected = [c for c in verify if c[2] is not None]
    _check(len(injected) == len(fail_calls) == proxy.fired
           and all("injected device failure" in c[2] for c in injected),
           f"fault stream {fail_calls}: unexpected failures {injected}")
    calls = dict(bls_backend.CALL_COUNTS)
    _check(calls["batch_verify_rlc"] > 0,
           f"fault stream {fail_calls}: no later flush reached the backend")
    if len(fail_calls) == 2:
        # rung 1: both RLC attempts failed, the per-group call served
        _check(verify[2][0] == "batch_fast_aggregate_verify"
               and verify[2][1] == poisoned and verify[2][2] is None
               and rec["fallback_items"] == 0
               and ladder["serve.rlc_error"] == 1
               and ladder["serve.backend_error"] == 0
               and not oracle_notes and not oracle_warnings,
               f"fault stream {fail_calls}: ladder {ladder}, calls "
               f"{[c[:2] for c in verify[:4]]}, fallback "
               f"{rec['fallback_items']}, oracle notes {oracle_notes}")
    else:
        # rung 2: the per-group attempts failed too, the oracle served,
        # journalled and warned about with the recorder off
        _check(rec["fallback_items"] == poisoned
               and ladder["serve.rlc_error"] == 1
               and ladder["serve.backend_error"] == 1
               and len(oracle_notes) == 1 and len(oracle_warnings) == 1
               and oracle_notes[0]["data"]["items"] == poisoned,
               f"fault stream {fail_calls}: fallback "
               f"{rec['fallback_items']} for a poisoned flush of "
               f"{poisoned}, ladder {ladder}, oracle notes {oracle_notes}, "
               f"warnings {len(oracle_warnings)}")
    return {"entry": "serve/load.run_serve_bench",
            "fail_calls": list(fail_calls), "events": rec["events"],
            "committees": rec["committees"], "k": rec["k"],
            "poisoned_flush_items": poisoned, "injected": proxy.fired,
            "fallback_items": rec["fallback_items"],
            "ladder_records": ladder, "oracle_notes": len(oracle_notes),
            "oracle_warnings": len(oracle_warnings), "call_counts": calls,
            "batches": rec["batches"], "elapsed_s": rec["elapsed_s"],
            "served_sigs_per_s": rec["value"],
            "verified_sigs_per_s": rec["verified_sigs_per_sec"],
            "p99_ms": rec["p99_ms"], "verdicts_exact": True}


def phase_serve(torch, card):
    """The serve plane on the card: the main stream (no fault), its offline
    floor, and the fault-injection streams whose fallback is on purpose."""
    main, launches, committees, distinct, verdicts = _serve_main(torch)
    offline = _serve_offline(torch, committees, distinct, verdicts)
    faults = [_serve_fault(torch, (1, 2)), _serve_fault(torch, (1, 2, 3, 4))]
    return {"phase": "serve", "main": main, "offline_floor": offline,
            "offline_over_stream_verified": (
                offline["verified_sigs_per_s"]
                / main["verified_sigs_per_s"]),
            "fault_injection": faults,
            "fault_injection_note": "these streams fall back on purpose",
            **card}, launches, {"committees": committees,
                                "verdicts": verdicts}


# ---------------------------------------------------------------------------
# phases 9-11: the wide buckets, the mainnet epoch through the collector,
# and the mainnet-scale plane
# ---------------------------------------------------------------------------

WIDE_KS = (512, 2048)  # the sync committee, the mainnet-max committee
NORTH_STAR_EPOCH_S = 2.0  # BASELINE: one mainnet epoch's checks in < 2 s
EPOCH_WARM_RUNS = 2
MAINNET_VALIDATORS = 1 << 20  # 64 committees of 512
MAINNET_RSS_BUDGET_MB = 8192  # the JAX package's bench/mainnet.py default
SCALE_SMOKE_VALIDATORS = 8192  # the port's scale/smoke.py default


def _add_counts(total, split):
    """Add a _split_run's kernel counts to a path's running total."""
    for k, key in (("vm_step", "step_kernel_launches"),
                   ("vm_step_steps", "step_kernel_steps"),
                   ("mont_mul", "mont_mul_kernel_launches")):
        total[k] = total.get(k, 0) + split[key]


def phase_wide(torch, pool, card):
    """The wide buckets: one committee of k keys, valid and with one signer
    dropped, through batch_fast_aggregate_verify and batch_verify_rlc,
    first then warm (the per-item entry's first run assembles the bucket's
    programs, the RLC entry's first run its combine)."""
    from consensus_specs_tpu_torch.ops import bls_backend
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    buckets, launches = [], {}
    for k in WIDE_KS:
        t0 = time.perf_counter()
        sks = list(range(1, k + 1))
        pks = pool.sk_to_pk(sks)
        msg = bytes([k % 251]) * 32
        sig = pool.sign([(sum(sks) % R, msg)])[0]
        setup_s = time.perf_counter() - t0
        sets, want = [pks, pks[1:]], [True, False]
        fold = bls_backend._fold_for("miller_product", k, len(sets))
        entry_runs = {}
        for entry in ("batch_fast_aggregate_verify", "batch_verify_rlc"):
            if entry == "batch_verify_rlc":
                def call():
                    return bls_backend.batch_verify_rlc(
                        [("fast_aggregate", p, msg, sig) for p in sets],
                        rng=random.Random(SEED))
            else:
                def call():
                    return bls_backend.batch_fast_aggregate_verify(
                        sets, [msg, msg], [sig, sig])
            runs = {}
            for label in ("first", "warm"):
                got, split = _split_run(torch, call)
                _check([bool(g) for g in got] == want,
                       f"wide k{k} {entry} {label}: verdicts "
                       f"{[bool(g) for g in got]}, want {want}")
                _add_counts(launches, split)
                runs[label] = split
            entry_runs[entry] = runs
        prog, _ = bls_backend._program("miller_product", k, fold=fold)
        buckets.append({
            "k": k, "k_bucket": bls_backend._k_bucket(k), "fold": fold,
            "miller_product_steps": int(prog.n_steps),
            "miller_product_registers": int(prog.n_regs),
            "setup_s": setup_s, "verdicts": want, "verdicts_exact": True,
            **{entry: runs for entry, runs in entry_runs.items()}})
    return {"phase": "wide", "buckets": buckets, **card}, launches


def _epoch_routes(col):
    """The collector's three flush routes: per item, RLC, and the port's
    serve plane (a new VerificationService for each run, so no verdict
    comes from an earlier run's result cache)."""
    from consensus_specs_tpu_torch.serve import VerificationService

    def service_flush():
        svc = VerificationService()
        try:
            got = col.flush(service=svc)
            snap = svc.metrics.snapshot()
        finally:
            svc.close(timeout=120)
        service_flush.snapshots.append(snap)
        return got
    service_flush.snapshots = []
    return {"flush": lambda: col.flush(),
            "flush_rlc": lambda: col.flush(rlc=True),
            "flush_service": service_flush}


def _epoch_run(torch, label, route_fn, want, launches):
    """One run of a flush route, split by _split_run. Fails on any wrong
    verdict, any ladder record and, for the service route, any fallback,
    retry or mesh fallback; adds its kernel counts to ``launches``."""
    from consensus_specs_tpu_torch.ops import profiling

    profiling.reset()
    got, split = _split_run(torch, route_fn)
    got = [bool(g) for g in got]
    wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    _check(len(got) == len(want) and not wrong,
           f"{label}: checks {wrong[:10]} answered wrong")
    ladder = _ladder_records()
    _check(not any(ladder.values()), f"{label}: ladder records {ladder}")
    snaps = getattr(route_fn, "snapshots", None)
    if snaps:
        snap = snaps[-1]
        for key in ("fallback_items", "backend_retries", "mesh_fallbacks"):
            _check(snap[key] == 0, f"{label}: {key} = {snap[key]}")
        split["service"] = {k: snap[k] for k in (
            "device_flushes", "batches", "prep_ms_per_flush",
            "device_ms_per_flush")}
    _add_counts(launches, split)
    return split


def _evict_checks(col):
    from consensus_specs_tpu_torch.ops import bls_backend

    for c in col.checks:
        bls_backend._MSG_CACHE.pop(bytes(c.messages), None)
        bls_backend._SIG_CACHE.pop(bytes(c.signature), None)


def _planted_epoch(triples, shape):
    """The epoch with 4 checks corrupted across the buckets (an attestation
    over a wrong message, one carrying the next check's signature, a sync
    aggregate missing a member, a proposer check with a malformed
    signature): (triples, {reason: index})."""
    slots, per = shape["slots"], shape["committees"]
    at = lambda slot, c: (slot % slots) * (per + 2) + c % per
    planted = {"wrong_message": at(3, 10),
               "other_check_signature": at(9, 40),
               "sync_missing_member": (17 % slots) * (per + 2) + per,
               "proposer_malformed_signature": (25 % slots) * (per + 2)
               + per + 1}
    out = list(triples)
    pks, msg, sig = out[planted["wrong_message"]]
    out[planted["wrong_message"]] = (pks, b"X" + msg[1:], sig)
    i = planted["other_check_signature"]
    out[i] = (out[i][0], out[i][1], out[i + 1][2])
    pks, msg, sig = out[planted["sync_missing_member"]]
    out[planted["sync_missing_member"]] = (pks[:-1], msg, sig)
    pks, msg, sig = out[planted["proposer_malformed_signature"]]
    out[planted["proposer_malformed_signature"]] = (
        pks, msg, bytes([sig[0] ^ 0x80]) + sig[1:])
    return out, planted


def phase_epoch(torch, pool, card):
    """BASELINE config 4 through the port's SignatureCollector: 32 slots of
    64 attestation aggregates of 146 signers (a pool of 512 keys), a sync
    aggregate of 512 and a proposer check each; every flush route cold,
    warm and fresh, then the epoch with 4 planted checks."""
    from consensus_specs_tpu_torch.bench import epoch_replay
    from consensus_specs_tpu_torch.utils import bls

    shape = epoch_replay.MAINNET
    n_sigs = epoch_replay.epoch_signatures(
        shape["slots"], shape["committees"], shape["k_att"], shape["k_sync"])
    t0 = time.perf_counter()
    triples = epoch_replay.epoch_triples(**shape, pool=pool)
    setup_s = time.perf_counter() - t0
    col = epoch_replay.collect(triples)
    n_checks = len(col.checks)
    want = [True] * n_checks

    launches, routes_out = {}, {}
    for name, fn in _epoch_routes(col).items():
        runs = {}
        for label in (["cold"] + [f"warm{i}" for i in range(EPOCH_WARM_RUNS)]
                      + ["fresh"]):
            if label == "fresh":
                _evict_checks(col)
            split = _epoch_run(torch, f"epoch {name} {label}", fn, want,
                               launches)
            split["sigs_per_s"] = n_sigs / split["wall_s"]
            split["under_north_star"] = split["wall_s"] < NORTH_STAR_EPOCH_S
            runs[label] = split
        warm = min((runs[f"warm{i}"] for i in range(EPOCH_WARM_RUNS)),
                   key=lambda r: r["wall_s"])
        routes_out[name] = {"warm_best": warm, "runs": runs}

    # the planted epoch, once through every route (inputs mostly cached)
    bad_triples, planted = _planted_epoch(triples, shape)
    bad = epoch_replay.collect(bad_triples)
    want_bad = [True] * n_checks
    for i in planted.values():
        want_bad[i] = False
    sample_valid = [0, shape["committees"], shape["committees"] + 1,
                    n_checks - 3]
    oracle = {}
    for i in sorted(set(planted.values()) | set(sample_valid)):
        c = bad.checks[i]
        t1 = time.perf_counter()
        v = bls.oracle_fast_aggregate_verify(c.pubkeys, c.messages,
                                             c.signature)
        _check(v == want_bad[i], f"epoch planted: oracle says {v} on check "
               f"{i}, planted {want_bad[i]}")
        oracle[str(i)] = {"verdict": v, "k": len(c.pubkeys),
                          "oracle_s": time.perf_counter() - t1}
    planted_runs = {
        name: _epoch_run(torch, f"epoch planted {name}", fn, want_bad,
                         launches)
        for name, fn in _epoch_routes(bad).items()}
    return {"phase": "epoch", "slots": shape["slots"],
            "committees": shape["committees"], "k_att": shape["k_att"],
            "k_sync": shape["k_sync"], "key_pool": shape["pool_size"],
            "checks": n_checks, "signatures": n_sigs,
            "setup_s": setup_s, "setup_processes": pool.processes,
            "north_star_s": NORTH_STAR_EPOCH_S, "verdicts_exact": True,
            "routes": routes_out, "planted": planted,
            "planted_oracle": oracle, "planted_runs": planted_runs,
            **card}, launches


def phase_mainnet(torch, pool, card):
    """The port's scale/smoke.py rounds (three-way verdict identity), then
    one slot of a 1,048,576-validator registry (64 committees of 512)
    through the hierarchical fold: cold, warm, and with a planted bad
    committee localized by bisection."""
    from consensus_specs_tpu_torch.ops import profiling
    from consensus_specs_tpu_torch.scale import hierarchy, smoke
    from consensus_specs_tpu_torch.scale.pubkeys import (PubkeyPlane,
                                                         peak_rss_bytes)
    from consensus_specs_tpu_torch.scale.registry import Registry

    launches = {}
    profiling.reset()
    rounds, split = _split_run(
        torch, lambda: smoke.run_rounds(SCALE_SMOKE_VALIDATORS, pool=pool))
    _add_counts(launches, split)
    scale_smoke = {"three_way_identity": True, "wall_s": split["wall_s"],
                   "step_kernel_launches": split["step_kernel_launches"],
                   "mont_mul_kernel_launches":
                       split["mont_mul_kernel_launches"], **rounds}

    t0 = time.perf_counter()
    reg = Registry(MAINNET_VALIDATORS, seed=20)
    per_slot = reg.committees_per_slot()
    committees = reg.committees_at_slot(0)
    shuffle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    items = hierarchy.committee_items(reg, slot=0, pool=pool)
    derive_s = time.perf_counter() - t0
    plane = PubkeyPlane()

    def slot_run(slot_items):
        rep, run = _split_run(torch, lambda: hierarchy.verify_slot(
            slot_items, slot=0, plane=plane, rng=random.Random(SEED)))
        _add_counts(launches, run)
        run.update({"attestations": rep.attestations,
                    "atts_per_s": rep.attestations / rep.verify_s,
                    "verify_s": rep.verify_s, "combines": rep.combines,
                    "bisections": rep.bisections,
                    "final_exps_per_slot": rep.final_exps_per_slot,
                    "pubkey_hits": rep.pubkey_hits,
                    "pubkey_misses": rep.pubkey_misses,
                    "bad_committees": rep.bad_committees})
        return rep, run

    cold_rep, cold = slot_run(items)
    warm_rep, warm = slot_run(items)
    hit_rate = warm_rep.pubkey_hits / max(
        1, warm_rep.pubkey_hits + warm_rep.pubkey_misses)
    for tag, rep in (("cold", cold_rep), ("warm", warm_rep)):
        _check(rep.all_valid, f"mainnet {tag}: committees "
               f"{rep.bad_committees} rejected in the valid slot")
        _check(rep.final_exps_per_slot == 1.0, f"mainnet {tag}: "
               f"final_exps_per_slot {rep.final_exps_per_slot}")
    _check(hit_rate == 1.0, f"mainnet warm: pubkey hit rate {hit_rate}")
    _check(plane.bytes <= plane.budget_bytes,
           f"mainnet: pubkey plane {plane.bytes} over {plane.budget_bytes}")

    bad_ci = per_slot // 2
    items_b = list(items)
    items_b[bad_ci] = hierarchy.corrupt_item(items_b[bad_ci])
    bad_rep, bad = slot_run(items_b)
    _check(bad_rep.bad_committees == [bad_ci] and bad_rep.bisections >= 1,
           f"mainnet bad committee: localized {bad_rep.bad_committees} by "
           f"{bad_rep.bisections} bisections, planted {bad_ci}")
    oracle = {}
    for ci in (bad_ci, 0):
        t1 = time.perf_counter()
        v = hierarchy.verify_slot_oracle([items_b[ci]])[0]
        _check(bool(v) == bool(bad_rep.verdicts[ci]),
               f"mainnet bad committee: oracle {bool(v)} on committee {ci}, "
               f"plane {bool(bad_rep.verdicts[ci])}")
        oracle[str(ci)] = {"verdict": bool(v),
                           "oracle_s": time.perf_counter() - t1}
    ladder = _ladder_records()
    _check(not any(ladder.values()), f"mainnet: ladder records {ladder}")
    peak_rss_mb = peak_rss_bytes() / (1 << 20)
    _check(peak_rss_mb <= MAINNET_RSS_BUDGET_MB,
           f"mainnet: peak RSS {peak_rss_mb:.0f} MiB over "
           f"{MAINNET_RSS_BUDGET_MB}")
    return {"phase": "mainnet", "scale_smoke": scale_smoke,
            # popped by main(): the fleet phase routes this slot again
            "_fleet_slot": (items_b, [bool(v) for v in bad_rep.verdicts]),
            "slot_replay": {
                "validators": MAINNET_VALIDATORS,
                "committees_per_slot": per_slot,
                "committee_size": len(committees[0]),
                "registry_shuffle_s": shuffle_s, "pubkey_derive_s": derive_s,
                "derive_processes": pool.processes,
                "atts_per_s_cold": cold["atts_per_s"],
                "atts_per_s_warm": warm["atts_per_s"],
                "final_exps_per_slot": warm_rep.final_exps_per_slot,
                "pubkey_hit_rate_warm": hit_rate,
                "pubkey_plane_bytes": plane.bytes,
                "pubkey_budget_bytes": plane.budget_bytes,
                "peak_rss_mb": peak_rss_mb,
                "rss_budget_mb": MAINNET_RSS_BUDGET_MB,
                "cold": cold, "warm": warm},
            "bad_committee": {"planted": bad_ci,
                              "localized": bad_rep.bad_committees,
                              "extra_final_exps": bad_rep.final_exps - 1,
                              "oracle": oracle, **bad},
            **card}, launches


# ---------------------------------------------------------------------------
# phase 12: the port's own executable spec on the card
# ---------------------------------------------------------------------------

# BASELINE config 1: phase0 minimal, 2,048 validators at 32 ETH, so 4
# committees of 64 a slot; one epoch of 8 blocks
SPEC_WORLD_A = {"fork": "phase0", "preset": "minimal", "validators": 2048}
# BASELINE config 3: altair mainnet, 1,024 validators, a sync committee of
# 512 seats drawn from them; two blocks, all seats and 3/4 of them signing
SPEC_WORLD_B = {"fork": "altair", "preset": "mainnet", "validators": 1024,
                "participation": (1.0, 0.75)}
HEAD_GOSSIP_BATCH = 8
HEAD_SINGLES = 64  # single-member attestations of the last slot


def _spec_world(pool, fork, preset, n):
    """The port's spec (its own builder) and a genesis of ``n`` validators
    from the port's helpers, whose key cache is filled from ``pool``
    (exact derivations in spawned processes)."""
    from consensus_specs_tpu_torch import builder
    from consensus_specs_tpu_torch.test.helpers import keys
    from consensus_specs_tpu_torch.test.helpers.genesis import (
        create_genesis_state,
    )

    spec = builder.build_spec_module(fork, preset)
    _check(spec.__name__ == f"consensus_specs_tpu_torch.{fork}.{preset}",
           f"spec module {spec.__name__}")
    missing = [i for i in range(n) if i not in keys.pubkeys._cache]
    for i, pk in zip(missing, pool.sk_to_pk([keys.privkeys[i]
                                             for i in missing])):
        keys.pubkeys._cache[i] = pk
    t0 = time.perf_counter()
    genesis = create_genesis_state(spec, [spec.MAX_EFFECTIVE_BALANCE] * n,
                                   spec.MAX_EFFECTIVE_BALANCE)
    return spec, genesis, time.perf_counter() - t0


@contextlib.contextmanager
def _pool_signatures(pool, pairs):
    """The switchboard's Sign answered from ``pool`` for ``pairs`` (sk,
    msg): the same bytes, derived in spawned processes, so a helper that
    signs member by member runs its own code at pool speed."""
    from consensus_specs_tpu_torch.utils import bls

    pairs = [(int(sk), bytes(m)) for sk, m in pairs]
    table = dict(zip(pairs, pool.sign(pairs)))

    def wrap(fn):
        def sign(sk, msg):
            hit = table.get((int(sk), bytes(msg)))
            return hit if hit is not None else fn(sk, msg)
        return sign
    with _patched(bls, "Sign", wrap):
        yield


def _aggregate_sig(spec, state, att):
    """(signing root, member privkeys) of an attestation: an aggregate is
    signed as Sign(sum sk mod r, root), the identity bench/epoch_replay
    uses."""
    from consensus_specs_tpu_torch.test.helpers.keys import privkeys

    root = bytes(spec.compute_signing_root(att.data, spec.get_domain(
        state, spec.DOMAIN_BEACON_ATTESTER, att.data.target.epoch)))
    members = sorted(spec.get_attesting_indices(state, att.data,
                                                att.aggregation_bits))
    return root, [privkeys[i] for i in members]


def _signed_aggregates(pool, spec, state, slot):
    """Every committee's full aggregate for ``slot`` (the port's helpers,
    unsigned), signed in one pool call."""
    from consensus_specs_tpu_torch.test.helpers.attestations import (
        get_valid_attestation,
    )
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    epoch = spec.compute_epoch_at_slot(slot)
    atts = [get_valid_attestation(spec, state, slot, index=i, signed=False)
            for i in range(int(spec.get_committee_count_per_slot(state,
                                                                 epoch)))]
    roots = [_aggregate_sig(spec, state, a) for a in atts]
    sigs = pool.sign([(sum(sks) % R, root) for root, sks in roots])
    for att, sig in zip(atts, sigs):
        att.signature = spec.BLSSignature(sig)
    return atts


def _seal(spec, state, block):
    """state_transition_and_sign_block with the block's own checks
    collected and dropped: sealing is set-up, the routes verify."""
    from consensus_specs_tpu_torch.batch_verify import SignatureCollector
    from consensus_specs_tpu_torch.test.helpers.state import (
        state_transition_and_sign_block,
    )

    with SignatureCollector(spec):
        return state_transition_and_sign_block(spec, state, block)


def _world_a_blocks(pool, spec, genesis, decorate=None):
    """One epoch of 8 blocks, each carrying the full aggregates of the
    slot before, and the last slot's aggregates (for gossip):
    (blocks, {slot: aggregates}). ``decorate(block, pre-state, last)``
    adds a fork's own operations before a block is sealed."""
    from consensus_specs_tpu_torch.test.helpers.block import (
        build_empty_block_for_next_slot,
    )

    state = genesis.copy()
    blocks, aggregates = [], {}
    n_blocks = int(spec.SLOTS_PER_EPOCH)
    for i in range(n_blocks):
        block = build_empty_block_for_next_slot(spec, state)
        if state.slot >= spec.MIN_ATTESTATION_INCLUSION_DELAY:
            aggregates[int(state.slot)] = _signed_aggregates(
                pool, spec, state, state.slot)
            for att in aggregates[int(state.slot)]:
                block.body.attestations.append(att)
        if decorate is not None:
            decorate(block, state, i == n_blocks - 1)
        blocks.append(_seal(spec, state, block))
    aggregates[int(state.slot)] = _signed_aggregates(pool, spec, state,
                                                     state.slot)
    return blocks, aggregates, state


def _world_b_blocks(pool, spec, genesis, participation, rng):
    """One block a slot after genesis, block i with a sync aggregate of
    ``participation[i]`` of the 512 seats (chosen with ``rng``), signed as
    Sign(sum over set seats of sk mod r): a duplicate member counts once
    per seat. Returns (blocks, [(pre-state, set seats, signing root)])."""
    from consensus_specs_tpu_torch.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu_torch.test.helpers.keys import privkeys
    from consensus_specs_tpu_torch.test.helpers.sync_committee import (
        compute_sync_committee_signing_root, get_committee_indices,
    )
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    state = genesis.copy()
    seats = get_committee_indices(spec, state)
    blocks, signed_over = [], []
    for share in participation:
        block = build_empty_block_for_next_slot(spec, state)
        n_set = int(round(share * len(seats)))
        chosen = set(rng.choice(len(seats), n_set, replace=False).tolist())
        bits = [i in chosen for i in range(len(seats))]
        root = bytes(compute_sync_committee_signing_root(spec, state,
                                                         block.slot))
        sk = sum(privkeys[seats[i]] for i in chosen) % R
        block.body.sync_aggregate = spec.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=pool.sign([(sk, root)])[0])
        signed_over.append((state.copy(), [seats[i] for i in sorted(chosen)],
                            root, block.slot))
        blocks.append(_seal(spec, state, block))
    return blocks, signed_over


def _same_as_member_by_member(pool, spec, got_sig, participants, root,
                              helper):
    """The shortcut Sign(sum sk) gives the bytes of the helpers' own
    member-by-member Aggregate (their Sign answered from the pool)."""
    from consensus_specs_tpu_torch.test.helpers.keys import privkeys

    t0 = time.perf_counter()
    with _pool_signatures(pool, [(privkeys[i], root) for i in participants]):
        want = bytes(helper())
    _check(want == bytes(got_sig),
           f"{spec.__name__}: Sign(sum sk) differs from the member-by-member "
           f"Aggregate over {len(participants)} keys")
    return {"keys": len(participants), "equal_bytes": True,
            "s": time.perf_counter() - t0}


def _check_summary(col_checks):
    """{"kind k<bucket>": [checks, signatures]} of collected checks."""
    from consensus_specs_tpu_torch.ops import bls_backend

    out = {}
    for c in col_checks:
        key = f"{c.kind} k{bls_backend._k_bucket(max(1, len(c.pubkeys)))}"
        n = out.setdefault(key, [0, 0])
        n[0] += 1
        n[1] += len(c.pubkeys)
    return out


def _replay_route(torch, route, spec, base, blocks):
    """One replay of ``blocks`` from ``base``: ``batched`` (the collector
    through replay_blocks_batched), ``sequential`` (state_transition with
    the switchboard on the card, a call a check) or ``no_bls``. Returns
    (roots after every block, verdicts or None, split). The host state
    transition is the time inside state_transition less the time inside
    the switchboard's verify calls (none on the batched route, whose
    collector records the checks)."""
    from consensus_specs_tpu_torch import batch_verify
    from consensus_specs_tpu_torch.utils import bls

    roots, stf, flushes, verifies = [], [], [], []

    def record_roots(fn):
        def transition(state, signed_block, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(state, signed_block, *args, **kwargs)
            stf.append(time.perf_counter() - t0)
            roots.append(bytes(state.hash_tree_root()))
            return out
        return transition

    def record_flush(fn):
        def flush(col, *args, **kwargs):
            flushes.append(_check_summary(col.checks))
            t0 = time.perf_counter()
            try:
                return fn(col, *args, **kwargs)
            finally:
                flushes.append(time.perf_counter() - t0)
        return flush

    state = base.copy()
    was, bls.bls_active = bls.bls_active, route != "no_bls"
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(spec, "state_transition",
                                         record_roots))
            stack.enter_context(_patched(batch_verify.SignatureCollector,
                                         "flush", record_flush))
            for name in ("FastAggregateVerify", "AggregateVerify", "Verify"):
                stack.enter_context(_patched(bls, name,
                                             _host_timer(verifies)))
            if route == "batched":
                got, split = _split_run(torch, lambda: (
                    batch_verify.replay_blocks_batched(spec, state, blocks)))
                got = [bool(g) for g in got]
            else:
                def sequential():
                    for signed in blocks:
                        spec.state_transition(state, signed)
                _, split = _split_run(torch, sequential)
                got = None
    finally:
        bls.bls_active = was
    split["state_transition_s"] = sum(stf)
    split["verify_calls"], split["verify_s"] = len(verifies), sum(verifies)
    split["host_state_transition_s"] = sum(stf) - sum(verifies)
    if route == "batched":
        split["checks_by_bucket"], split["flush_s"] = flushes
    split["blocks_per_s"] = len(blocks) / split["wall_s"]
    return roots, got, split


def _three_routes(torch, label, spec, base, blocks):
    """Routes 1 and 2 cold then warm, route 3 once; equal roots after
    every block, every check True. Returns (runs, checks, signatures)."""
    runs, want_roots, n_checks = {}, None, None
    for route, tags in (("batched", ("cold", "warm")),
                        ("sequential", ("cold", "warm")),
                        ("no_bls", ("once",))):
        for tag in tags:
            roots, got, split = _replay_route(torch, route, spec, base,
                                              blocks)
            want_roots = roots if want_roots is None else want_roots
            differ = [i for i, (a, b) in enumerate(zip(roots, want_roots))
                      if a != b]
            _check(len(roots) == len(want_roots) and not differ,
                   f"{label} {route} {tag}: post-state roots differ after "
                   f"blocks {differ}")
            if got is not None:
                _check(all(got), f"{label} {route} {tag}: checks "
                       f"{[i for i, g in enumerate(got) if not g]} False")
                n_checks = len(got)
                n_sigs = sum(n for _, n in
                             split["checks_by_bucket"].values())
            ladder = _ladder_records()
            _check(not any(ladder.values()),
                   f"{label} {route} {tag}: ladder records {ladder}")
            runs[f"{route}_{tag}"] = split
    for key, split in runs.items():
        if not key.startswith("no_bls"):
            split["signatures_per_s"] = n_sigs / split["wall_s"]
    return runs, n_checks, n_sigs, want_roots


def _planted_block(spec, base, blocks, k, mutate):
    """blocks[:k] and a copy of blocks[k] changed by ``mutate(block,
    pre-state)``, re-sealed (state root from a BLS-off transition) and
    re-signed by its proposer: the prefix to replay."""
    from consensus_specs_tpu_torch.test.helpers.block import sign_block
    from consensus_specs_tpu_torch.utils import bls

    pre = _post_state(spec, base, blocks[:k])
    bad = blocks[k].message.copy()
    mutate(bad, pre)
    scratch = pre.copy()
    was, bls.bls_active = bls.bls_active, False
    try:
        spec.process_slots(scratch, bad.slot)
        spec.process_block(scratch, bad)
    finally:
        bls.bls_active = was
    bad.state_root = spec.hash_tree_root(scratch)
    return list(blocks[:k]) + [sign_block(spec, pre, bad)]


def _planted_run(torch, label, spec, base, prefix, planted_kind, planted_k):
    """Route 1 on a planted prefix: exactly one check False, of
    ``planted_kind`` over ``planted_k`` keys, and the oracle agreeing on
    that check and on one valid check."""
    from consensus_specs_tpu_torch import batch_verify
    from consensus_specs_tpu_torch.utils import bls

    state = base.copy()
    with batch_verify.SignatureCollector(spec) as col:
        for signed in prefix:
            spec.state_transition(state, signed)
    got, split = _split_run(torch, col.flush)
    got = [bool(g) for g in got]
    bad = [i for i, g in enumerate(got) if not g]
    _check(len(bad) == 1 and col.checks[bad[0]].kind == planted_kind
           and len(col.checks[bad[0]].pubkeys) == planted_k,
           f"{label}: flagged checks {bad}, want one {planted_kind} over "
           f"{planted_k} keys")
    good = got.index(True)
    oracle = {}
    for i in (bad[0], good):
        c = col.checks[i]
        t0 = time.perf_counter()
        oracle_fn = (bls.oracle_aggregate_verify if c.kind == "aggregate"
                     else bls.oracle_fast_aggregate_verify)
        v = oracle_fn(c.pubkeys, c.messages, c.signature)
        _check(v == got[i], f"{label}: oracle {v} on check {i}, card {got[i]}")
        oracle[str(i)] = {"verdict": v, "k": len(c.pubkeys),
                          "oracle_s": time.perf_counter() - t0}
    return {"checks": len(got), "flagged": bad, "oracle": oracle,
            "wall_s": split["wall_s"],
            **{k: split[k] for k in ("step_kernel_launches",
                                     "step_kernel_steps",
                                     "mont_mul_kernel_launches")}}


def _head_service_run(torch, spec, genesis, blocks, aggregates, pool):
    """World A's epoch through HeadService over a VerificationService on
    the card, differential on: two early aggregates defer until their
    block, the 8 blocks through on_block, then the aggregates, the last
    slot's single-member attestations and two BAD_SIGNATURE copies as
    gossip in batches of 8. Returns the line's dict and the split."""
    from consensus_specs_tpu_torch.chain import HeadService
    from consensus_specs_tpu_torch.obs import latency
    from consensus_specs_tpu_torch.ops import profiling
    from consensus_specs_tpu_torch.serve import VerificationService
    from consensus_specs_tpu_torch.serve.load import BAD_SIGNATURE
    from consensus_specs_tpu_torch.test.helpers.attestations import (
        get_valid_attestation,
    )
    from consensus_specs_tpu_torch.test.helpers.keys import privkeys

    last_slot = int(blocks[-1].message.slot)
    # the last slot's singles: committee 0's members, each alone
    post = _post_state(spec, genesis, blocks)
    members = list(spec.get_beacon_committee(post, last_slot, 0))[
        :HEAD_SINGLES]
    singles = [get_valid_attestation(spec, post, last_slot, index=0,
                                     filter_participant_set=(
                                         lambda _c, m=member: {m}))
               for member in members]
    roots = [_aggregate_sig(spec, post, a)[0] for a in singles]
    sigs = pool.sign([(privkeys[m], r) for m, r in zip(members, roots)])
    for att, sig in zip(singles, sigs):
        att.signature = spec.BLSSignature(sig)
    bad = [a.copy() for a in singles[:2]]
    for att in bad:
        att.signature = spec.BLSSignature(BAD_SIGNATURE)
    early = aggregates[1][:2]
    gossip = singles + bad + [a for s in sorted(aggregates)
                              for a in aggregates[s]]

    profiling.reset()
    heads = []  # each new head root, in order
    seconds_per_slot = int(spec.config.SECONDS_PER_SLOT)

    def note_head(head):
        root = bytes(head.get_head()).hex()[:16]
        if not heads or heads[-1] != root:
            heads.append(root)

    def run():
        svc = VerificationService()
        try:
            anchor = spec.BeaconBlock(state_root=genesis.hash_tree_root())
            head = HeadService(spec, genesis.copy(), anchor, service=svc,
                               differential=True)
            store = head.store

            def tick(slot):
                head.on_tick(store.genesis_time + slot * seconds_per_slot)

            tick(2)
            head.on_attestations(early,
                                 births=[latency.birth() for _ in early])
            _check(head.deferred_count == 2,
                   f"head: {head.deferred_count} deferred, want 2")
            for signed in blocks:
                tick(max(2, int(signed.message.slot)))
                head.on_block(signed)
                note_head(head)
            tick(last_slot + 1)
            for i in range(0, len(gossip), HEAD_GOSSIP_BATCH):
                batch = gossip[i:i + HEAD_GOSSIP_BATCH]
                head.on_attestations(
                    batch, births=[latency.birth() for _ in batch])
                note_head(head)
            _check(bytes(head.get_head()) == bytes(spec.get_head(store)),
                   "head: proto-array head differs from spec.get_head")
            return head, svc.metrics.snapshot()
        finally:
            svc.close(timeout=120)

    (head, svc_snap), split = _split_run(torch, run)
    snap = head.metrics.snapshot()
    _check(snap["dropped"] == 2, f"head: {snap['dropped']} dropped, want 2")
    _check(snap["deferred"] == 2 and snap["resolved"] == 2,
           f"head: deferred {snap['deferred']}, resolved {snap['resolved']}")
    for key in ("fallback_items", "backend_retries", "mesh_fallbacks"):
        _check(svc_snap[key] == 0, f"head: service {key} = {svc_snap[key]}")
    ladder = _ladder_records()
    _check(not any(ladder.values()), f"head: ladder records {ladder}")
    g2h = profiling.latency_histograms().get(latency.GOSSIP_TO_HEAD_LABEL)
    _check(g2h is not None and g2h.count > 0, "head: no gossip->head sample")
    line = {
        "blocks": len(blocks), "gossip": len(gossip) + len(early),
        "batches": snap["batches"], "heads": heads,
        "head_changes": snap["head_changes"], "reorgs": snap["reorgs"],
        "applied": snap["applied"], "stale": snap["stale"],
        "dropped": snap["dropped"], "deferred": snap["deferred"],
        "resolved": snap["resolved"], "differential": True,
        "gossip_to_head_p50_ms": 1e3 * g2h.percentile(50.0),
        "gossip_to_head_p99_ms": 1e3 * g2h.percentile(99.0),
        "gossip_to_head_n": g2h.count,
        "service": {k: svc_snap[k] for k in (
            "submits", "batches", "device_flushes", "cache_hits",
            "fallback_items", "backend_retries", "mesh_fallbacks",
            "ladder_rung", "prep_ms_per_flush", "device_ms_per_flush")},
        "ladder": ladder, **{k: split[k] for k in (
            "wall_s", "vm_execute_s", "step_kernel_ms",
            "step_kernel_launches", "mont_mul_kernel_launches")}}
    return line, split


def _post_state(spec, genesis, blocks):
    """The state after ``blocks``, replayed with BLS off."""
    from consensus_specs_tpu_torch.utils import bls

    state = genesis.copy()
    was, bls.bls_active = bls.bls_active, False
    try:
        for signed in blocks:
            spec.state_transition(state, signed)
    finally:
        bls.bls_active = was
    return state


def phase_spec(torch, pool, card):
    """The port's own executable spec on the card: world A (BASELINE config
    1, phase0 minimal) and world B (config 3, altair mainnet) replayed
    three ways with equal post-state roots, a planted check flagged in
    each, and world A's epoch through the HeadService on a card
    VerificationService."""
    from consensus_specs_tpu_torch.test.helpers.attestations import (
        sign_aggregate_attestation,
    )
    from consensus_specs_tpu_torch.test.helpers.sync_committee import (
        compute_aggregate_sync_committee_signature,
    )
    from consensus_specs_tpu_torch.utils import bls
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    was = (bls.bls_active, bls._backend)
    bls.use_gpu()
    bls.bls_active = True
    launches, out = {}, {"phase": "spec"}
    try:
        # -- world A ------------------------------------------------------
        wa = SPEC_WORLD_A
        t0 = time.perf_counter()
        spec, genesis, genesis_s = _spec_world(pool, wa["fork"],
                                               wa["preset"], wa["validators"])
        blocks, aggregates, _ = _world_a_blocks(pool, spec, genesis)
        setup_s = time.perf_counter() - t0
        # the identity on one committee: the helpers' member-by-member sum
        one = aggregates[1][0]
        pre1 = _post_state(spec, genesis, blocks[:1])
        root, _ = _aggregate_sig(spec, pre1, one)
        members = sorted(spec.get_attesting_indices(pre1, one.data,
                                                    one.aggregation_bits))
        ident_a = _same_as_member_by_member(
            pool, spec, one.signature, members, root,
            lambda: sign_aggregate_attestation(spec, pre1, one.data,
                                               members))
        runs, n_checks, n_sigs, roots = _three_routes(torch, "world A", spec,
                                                      genesis, blocks)
        for split in runs.values():
            _add_counts(launches, split)
        # planted: one aggregate of block 5 signs another message
        k = min(4, len(blocks) - 1)

        def wrong_message(block, pre):
            att = block.body.attestations[0]
            root, sks = _aggregate_sig(spec, pre, att)
            att.signature = spec.BLSSignature(pool.sign(
                [(sum(sks) % R, bytes([root[0] ^ 0xff]) + root[1:])])[0])
        prefix = _planted_block(spec, genesis, blocks, k, wrong_message)
        planted_a = _planted_run(
            torch, "world A planted", spec, genesis, prefix,
            "fast_aggregate", len(blocks[k].message.body.attestations[0]
                                  .aggregation_bits))
        _add_counts(launches, planted_a)
        head_line, head_split = _head_service_run(torch, spec, genesis,
                                                  blocks, aggregates, pool)
        _add_counts(launches, head_split)
        out["world_a"] = {
            "config": "BASELINE config 1", **wa,
            "committees_per_slot": int(spec.get_committee_count_per_slot(
                genesis, 0)),
            "committee_size": len(spec.get_beacon_committee(genesis, 1, 0)),
            "blocks": len(blocks),
            "attestations": sum(len(b.message.body.attestations)
                                for b in blocks),
            "checks": n_checks, "signatures": n_sigs,
            "genesis_s": genesis_s, "setup_s": setup_s,
            "member_by_member": ident_a, "roots_equal": True,
            "final_root": roots[-1].hex()[:16], "routes": runs,
            "planted": planted_a, "head_service": head_line}

        # -- world B ------------------------------------------------------
        wb = SPEC_WORLD_B
        t0 = time.perf_counter()
        spec_b, genesis_b, genesis_b_s = _spec_world(
            pool, wb["fork"], wb["preset"], wb["validators"])
        blocks_b, signed_over = _world_b_blocks(
            pool, spec_b, genesis_b, wb["participation"],
            np.random.default_rng(SEED))
        setup_b_s = time.perf_counter() - t0
        pre, participants, root, slot = signed_over[-1]
        ident_b = _same_as_member_by_member(
            pool, spec_b,
            blocks_b[-1].message.body.sync_aggregate.sync_committee_signature,
            participants, root,
            lambda: compute_aggregate_sync_committee_signature(
                spec_b, pre, slot, participants))
        runs_b, n_checks_b, n_sigs_b, roots_b = _three_routes(
            torch, "world B", spec_b, genesis_b, blocks_b)
        for split in runs_b.values():
            _add_counts(launches, split)

        def cleared_bit(block, _pre):
            bits = block.body.sync_aggregate.sync_committee_bits
            bits[next(i for i in range(len(bits)) if bits[i])] = False
        prefix_b = _planted_block(spec_b, genesis_b, blocks_b, 0,
                                  cleared_bit)
        n_set = sum(bool(b) for b in
                    blocks_b[0].message.body.sync_aggregate
                    .sync_committee_bits)
        planted_b = _planted_run(torch, "world B planted", spec_b,
                                 genesis_b, prefix_b, "fast_aggregate",
                                 n_set - 1)
        _add_counts(launches, planted_b)
        out["world_b"] = {
            "config": "BASELINE config 3", **wb,
            "sync_committee_size": int(spec_b.SYNC_COMMITTEE_SIZE),
            "distinct_sync_members": len(set(
                bytes(pk) for pk in genesis_b.current_sync_committee.pubkeys)),
            "sync_bits_set": [sum(bool(b) for b in
                                  blk.message.body.sync_aggregate
                                  .sync_committee_bits) for blk in blocks_b],
            "blocks": len(blocks_b), "checks": n_checks_b,
            "signatures": n_sigs_b, "genesis_s": genesis_b_s,
            "setup_s": setup_b_s, "member_by_member": ident_b,
            "roots_equal": True, "final_root": roots_b[-1].hex()[:16],
            "routes": runs_b, "planted": planted_b}
    finally:
        bls.bls_active, bls._backend = was
    return {**out, "launches": dict(launches), **card}, launches


# ---------------------------------------------------------------------------
# phase 13: BASELINE config 5, batched KZG point proofs on the card
# ---------------------------------------------------------------------------

# the edge and planted items among the 256, by (polynomial, point): the
# constant polynomial 0 (every proof of it is the point at infinity) holds
# the infinity item, the z == tau item and two wrong values
KZG_PLANTS = {(0, 0): "infinity", (0, 1): "z_is_tau", (0, 2): "wrong_y",
              (0, 3): "wrong_y", (1, 0): "wrong_y", (1, 1): "wrong_z",
              (1, 2): "wrong_z", (1, 3): "wrong_z", (2, 0): "other_proof",
              (2, 1): "other_proof"}
KZG_ORACLE_VALID = 16  # valid items the oracle also checks
KZG_WARM_RUNS = 2


def _kzg_prove(job):
    """One polynomial's commitment and proofs with the port's kzg, in a
    spawned worker of the key pool: (tau, n, coeffs, zs) -> (commitment,
    [(proof, y)]), oracle points."""
    from consensus_specs_tpu_torch.utils import kzg

    tau, n, coeffs, zs = job
    setup = kzg.lazy_setup(tau, n)
    return (kzg.commit_to_poly(setup, coeffs),
            [kzg.prove_at_point(setup, coeffs, z) for z in zs])


def _kzg_oracle(job):
    """The port's exact-int verify_point_proof on one item, in a worker:
    (tau, n, commitment, proof, z, y) -> (verdict, seconds)."""
    from consensus_specs_tpu_torch.utils import kzg

    tau, n, c, p, z, y = job
    t0 = time.perf_counter()
    v = kzg.verify_point_proof(kzg.lazy_setup(tau, n), c, p, z, y)
    return v, time.perf_counter() - t0


def _kzg_items(pool, spec, rng):
    """One point proof for each commitment of a full mainnet slot: the
    sharding mainnet preset's INITIAL_ACTIVE_SHARDS polynomials of
    POINTS_PER_SAMPLE coefficients, each proved at
    MAX_SHARD_HEADERS_PER_SHARD points with the port's commit_to_poly and
    prove_at_point, KZG_PLANTS planted, in a seeded shuffled order.
    Returns [(commitment, proof, z, y, truth, label)]."""
    from consensus_specs_tpu_torch.utils import kzg

    tau, n = int(spec.KZG_SETUP_TAU), int(spec.KZG_SETUP_SIZE)
    n_polys = int(spec.INITIAL_ACTIVE_SHARDS)
    per = int(spec.MAX_SHARD_HEADERS_PER_SHARD)
    width = int(spec.POINTS_PER_SAMPLE)

    def field():
        return int.from_bytes(rng.bytes(32), "big") % kzg.MODULUS
    polys = [[field() for _ in range(width)] for _ in range(n_polys)]
    polys[0] = [field()] + [0] * (width - 1)
    zs = [[field() for _ in range(per)] for _ in range(n_polys)]
    zs[0][1] = tau
    proved = pool.map(_kzg_prove, [(tau, n, c, z) for c, z in zip(polys, zs)])
    setup = spec.KZG_SETUP
    items = []
    for i, (commitment, proofs) in enumerate(proved):
        for j, (proof, y) in enumerate(proofs):
            z, label = zs[i][j], KZG_PLANTS.get((i, j), "valid")
            if label == "wrong_y":
                y = (y + 1) % kzg.MODULUS
            elif label == "wrong_z":
                z = (z + 1) % kzg.MODULUS
            elif label == "other_proof":
                proof, _ = kzg.prove_at_point(setup, polys[3 + j], z)
            truth = label not in ("wrong_y", "wrong_z", "other_proof")
            items.append((commitment, proof, z, y, truth, label))
    return [items[k] for k in rng.permutation(len(items))]


def _kzg_run(torch, setup, items):
    """One batch_verify_point_proofs call on the card, its wall split into
    host scalar prep (the per-item G2 and G1 multiplications and staging),
    program resolution, PROG A's vm.execute, the serial easy part and the
    hard part, with the step kernels' CUDA-event ms and launches."""
    from consensus_specs_tpu_torch.ops import kzg_backend, vm

    layout, easy, hard, execs, first = [], [], [], [], []

    def timed_in_order(fn):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            if not first:
                first.append(t)
            try:
                return fn(*args, **kwargs)
            finally:
                execs.append(time.perf_counter() - t)
        return wrapped
    with _patched(kzg_backend, "_FoldLayout", _host_timer(layout)), \
            _patched(kzg_backend, "_easy_part_flat", _host_timer(easy)), \
            _patched(kzg_backend, "_run_hard_part", _host_timer(hard)), \
            _patched(vm, "execute", timed_in_order):
        t0 = time.perf_counter()
        got, split = _split_run(torch, lambda: (
            kzg_backend.batch_verify_point_proofs(
                setup, *[[it[j] for it in items] for j in range(4)])))
    prep = (first[0] if first else t0 + split["wall_s"]) - t0 - sum(layout)
    split.update({
        "host_scalar_prep_s": prep, "layout_s": sum(layout),
        "easy_part_s": sum(easy), "hard_part_s": sum(hard),
        "prog_a_vm_execute_s": execs[0] if execs else 0.0,
        "hard_part_vm_execute_s": sum(execs[1:]),
        "proofs_per_s": len(items) / split["wall_s"]})
    return [bool(g) for g in got], split


def phase_kzg(torch, pool, card):
    """BASELINE config 5 at full width: 256 KZG point proofs (one for each
    commitment of a full mainnet slot) against the port's own sharding
    mainnet setup (16,384 lazy points), through
    kzg_backend.batch_verify_point_proofs on the card: cold, then warm;
    every verdict the constructed truth; the port's exact-int oracle
    agreeing on the planted and edge items and on a sample of valid ones;
    the z == tau item alone launching nothing."""
    from consensus_specs_tpu_torch import builder
    from consensus_specs_tpu_torch.ops import cuda_step, kzg_backend

    spec = builder.build_spec_module("sharding", "mainnet")
    setup = spec.KZG_SETUP
    _check(int(spec.KZG_SETUP_SIZE) == 16384 and setup.n == 16384,
           f"KZG setup of {setup.n} points")
    rng = np.random.default_rng([SEED, 5])
    t0 = time.perf_counter()
    items = _kzg_items(pool, spec, rng)
    setup_s = time.perf_counter() - t0
    n_items = int(spec.INITIAL_ACTIVE_SHARDS) \
        * int(spec.MAX_SHARD_HEADERS_PER_SHARD)
    _check(len(items) == n_items == 256, f"{len(items)} KZG items")
    want = [it[4] for it in items]
    launches, runs = {}, {}
    for tag in ["cold"] + [f"warm{i + 1}" for i in range(KZG_WARM_RUNS)]:
        got, split = _kzg_run(torch, setup, items)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        _check(not bad, f"kzg {tag}: verdicts differ from the truth at "
                        f"{[(i, items[i][5]) for i in bad]}")
        _check(split["step_kernel_launches"] == 2,
               f"kzg {tag}: {split['step_kernel_launches']} launches")
        _add_counts(launches, split)
        runs[tag] = split
    # the oracle on every planted or edge item and on a sample of valid
    # ones, in the pool's processes
    edge = [i for i, it in enumerate(items) if it[5] != "valid"]
    valid = [i for i, it in enumerate(items) if it[5] == "valid"]
    sample = edge + sorted(rng.choice(valid, KZG_ORACLE_VALID,
                                      replace=False).tolist())
    tau, n = int(spec.KZG_SETUP_TAU), int(spec.KZG_SETUP_SIZE)
    t0 = time.perf_counter()
    oracle = pool.map(_kzg_oracle, [(tau, n) + tuple(items[i][:4])
                                    for i in sample])
    oracle_s = time.perf_counter() - t0
    differ = [i for i, (v, _) in zip(sample, oracle) if v != want[i]]
    _check(not differ, f"kzg: the oracle differs at {differ}")
    # the z == tau item alone: answered by the oracle, nothing launched
    tau_item = next(it for it in items if it[5] == "z_is_tau")
    got_tau, tau_split = _split_run(torch, lambda: (
        kzg_backend.batch_verify_point_proofs(
            setup, *[[tau_item[j]] for j in range(4)])))
    _check(list(got_tau) == [True] and cuda_step.LAUNCHES == 0
           and tau_split["vm_executions"] == 0,
           f"kzg z == tau alone: {list(got_tau)}, "
           f"{tau_split['step_kernel_launches']} launches")
    _add_counts(launches, tau_split)
    return {"phase": "kzg", "config": "BASELINE config 5",
            "setup": {"fork": "sharding", "preset": "mainnet",
                      "points": setup.n, "lazy": True},
            "items": n_items, "polynomials": int(spec.INITIAL_ACTIVE_SHARDS),
            "coefficients": int(spec.POINTS_PER_SAMPLE),
            "points_per_polynomial": int(spec.MAX_SHARD_HEADERS_PER_SHARD),
            "planted": sorted(set(KZG_PLANTS.values())),
            "false_items": want.count(False), "set_up_s": setup_s,
            "verdicts_exact": True,
            "oracle": {"items": len(sample), "edge": len(edge),
                       "agree": True, "s": oracle_s,
                       "item_s_max": max(s for _, s in oracle)},
            "z_is_tau_alone": {"verdict": True, "launches": 0,
                               "wall_s": tau_split["wall_s"]},
            "runs": {tag: {k: split[k] for k in (
                "wall_s", "proofs_per_s", "host_scalar_prep_s", "layout_s",
                "assemble_s", "prog_a_vm_execute_s", "hard_part_vm_execute_s",
                "vm_execute_s",
                "step_kernel_ms", "easy_part_s", "hard_part_s",
                "other_host_s", "step_kernel_launches", "step_kernel_steps",
                "mont_mul_kernel_launches")} for tag, split in runs.items()},
            "launches": dict(launches), **card}, launches


# ---------------------------------------------------------------------------
# phase 14: the merge, sharding and custody_game forks on the card
# ---------------------------------------------------------------------------

# world C: merge minimal, after the complete transition, at half world A's
# size: altair-era attestation processing recomputes the total active
# balance for every attester (get_base_reward), so a replay's host time
# grows with the square of the registry (21.6-26.8 s at 2,048 validators
# on the H100's host, against world A's 0.24-0.74 s)
SPEC_WORLD_C = {"fork": "merge", "preset": "minimal", "validators": 1024}
# world D: sharding minimal (INITIAL_ACTIVE_SHARDS 2); the base state sits
# at the first slot of epoch 1, whose shard work the genesis epoch's
# transition armed; 7 blocks stay inside epoch 1 (an altair-era epoch
# transition past genesis costs the pure-Python spec about a minute at
# 2,048 validators)
SPEC_WORLD_D = {"fork": "sharding", "preset": "minimal", "validators": 2048,
                "blocks": 7, "header_blocks": 4}
# world E: custody_game minimal; a key reveal needs a custody period that
# has ended, 31 epochs in for validator i with i % 32 == 1, which the walk
# of empty slots reaches at a size it can afford; its 8 blocks fill epoch
# 31 (the next epoch transition rotates the sync committee, whose
# aggregate pubkey a BLS-off replay stubs, so its roots would differ)
SPEC_WORLD_E = {"fork": "custody_game", "preset": "minimal",
                "validators": 128}


def _merge_payload(spec):
    """World C's block decoration: an empty execution payload on the
    state at the block's slot."""
    from consensus_specs_tpu_torch.test.helpers.execution_payload import (
        build_empty_execution_payload,
    )

    def decorate(block, state, last):
        at = state.copy()
        spec.process_slots(at, block.slot)
        block.body.execution_payload = build_empty_execution_payload(spec, at)
    return decorate


def _custody_reveals(spec):
    """World E's decoration of its last block (slot 255, epoch 31): a
    custody key reveal of every validator i with i % 32 == 1 (whose first
    period has ended; the draft's exit-period test overflows a uint64 for
    i % 32 > 1) and an early derived secret reveal."""
    from consensus_specs_tpu_torch.test.helpers.custody_game import (
        get_valid_custody_key_reveal, get_valid_early_derived_secret_reveal,
    )

    def decorate(block, state, last):
        if not last:
            return
        period = int(spec.EPOCHS_PER_CUSTODY_PERIOD)
        for i in range(len(state.validators)):
            if i % period == 1:
                block.body.custody_key_reveals.append(
                    get_valid_custody_key_reveal(spec, state,
                                                 validator_index=i))
        block.body.early_derived_secret_reveals.append(
            get_valid_early_derived_secret_reveal(spec, state))
    return decorate


def _world_d_blocks(spec, base, n_blocks, header_blocks):
    """World D: ``n_blocks`` blocks after ``base``; each of the first
    ``header_blocks`` carries a shard header for the slot before on every
    active shard (commitment, degree proof, builder and proposer
    signatures), the last one a shard proposer slashing."""
    from consensus_specs_tpu_torch.test.helpers.block import (
        build_empty_block_for_next_slot,
    )
    from consensus_specs_tpu_torch.test.helpers.shard_blob import (
        build_shard_blob_header, build_shard_proposer_slashing,
    )

    state = base.copy()
    blocks, seed = [], 1
    for i in range(n_blocks):
        block = build_empty_block_for_next_slot(spec, state)
        if i < header_blocks:
            shards = int(spec.get_active_shard_count(
                state, spec.compute_epoch_at_slot(state.slot)))
            for shard in range(shards):
                block.body.shard_headers.append(build_shard_blob_header(
                    spec, state, slot=state.slot, shard=shard,
                    data_seed=seed))
                seed += 1
        if i == n_blocks - 1:
            block.body.shard_proposer_slashings.append(
                build_shard_proposer_slashing(spec, state, slot=state.slot))
        blocks.append(_seal(spec, state, block))
    return blocks


def _fork_world(torch, label, spec, base, blocks, planted_k, mutate,
                planted_kind, planted_keys):
    """The three routes on ``blocks`` from ``base`` and the planted run on
    ``blocks[:planted_k]`` and a copy of ``blocks[planted_k]`` changed by
    ``mutate``. Returns (line, launches)."""
    launches = {}
    runs, n_checks, n_sigs, roots = _three_routes(torch, label, spec, base,
                                                  blocks)
    for split in runs.values():
        _add_counts(launches, split)
    prefix = _planted_block(spec, base, blocks, planted_k, mutate)
    planted = _planted_run(torch, f"{label} planted", spec, base, prefix,
                           planted_kind, planted_keys)
    _add_counts(launches, planted)
    return {"blocks": len(blocks), "checks": n_checks, "signatures": n_sigs,
            "roots_equal": True, "final_root": roots[-1].hex()[:16],
            "routes": runs, "planted": planted}, launches


def phase_forks(torch, pool, card):
    """The port's merge, sharding and custody_game specs with the
    switchboard on the card: worlds C, D and E replayed three ways with
    equal post-state roots, and a planted check flagged in each."""
    from consensus_specs_tpu_torch.test.helpers.execution_payload import (
        build_state_with_complete_transition,
    )
    from consensus_specs_tpu_torch.test.helpers.shard_blob import (
        build_shard_blob_header,
    )
    from consensus_specs_tpu_torch.test.helpers.state import transition_to
    from consensus_specs_tpu_torch.utils import bls
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    was = (bls.bls_active, bls._backend)
    bls.use_gpu()
    bls.bls_active = True
    launches, out = {}, {"phase": "forks"}

    def count(world_launches):
        for k, v in world_launches.items():
            launches[k] = launches.get(k, 0) + v
    try:
        # -- world C: merge ------------------------------------------------
        wc = SPEC_WORLD_C
        t0 = time.perf_counter()
        spec, genesis, _ = _spec_world(pool, wc["fork"], wc["preset"],
                                       wc["validators"])
        build_state_with_complete_transition(spec, genesis)
        blocks, _, _ = _world_a_blocks(pool, spec, genesis,
                                       _merge_payload(spec))
        setup_s = time.perf_counter() - t0

        def wrong_message(block, pre):
            att = block.body.attestations[0]
            root, sks = _aggregate_sig(spec, pre, att)
            att.signature = spec.BLSSignature(pool.sign(
                [(sum(sks) % R, bytes([root[0] ^ 0xff]) + root[1:])])[0])
        k = min(4, len(blocks) - 1)
        line, world = _fork_world(
            torch, "world C", spec, genesis, blocks, k, wrong_message,
            "fast_aggregate",
            len(blocks[k].message.body.attestations[0].aggregation_bits))
        count(world)
        out["world_c"] = {**wc, "setup_s": setup_s,
                          "payloads": len(blocks), "attestations": sum(
                              len(b.message.body.attestations)
                              for b in blocks), **line}

        # -- world D: sharding ---------------------------------------------
        wd = SPEC_WORLD_D
        t0 = time.perf_counter()
        spec_d, genesis_d, _ = _spec_world(pool, wd["fork"], wd["preset"],
                                           wd["validators"])
        base_d = genesis_d.copy()
        transition_to(spec_d, base_d, int(spec_d.SLOTS_PER_EPOCH))
        blocks_d = _world_d_blocks(spec_d, base_d, wd["blocks"],
                                   wd["header_blocks"])
        setup_d_s = time.perf_counter() - t0

        def foreign_signature(block, pre):
            header = block.body.shard_headers[0]
            other = build_shard_blob_header(
                spec_d, pre, slot=header.message.slot,
                shard=header.message.shard, data_seed=1000)
            header.signature = other.signature
        headers = sum(len(b.message.body.shard_headers) for b in blocks_d)
        line, world = _fork_world(torch, "world D", spec_d, base_d, blocks_d,
                                  2, foreign_signature, "fast_aggregate", 2)
        count(world)
        out["world_d"] = {
            **wd, "active_shards": int(spec_d.get_active_shard_count(
                base_d, spec_d.get_current_epoch(base_d))),
            "shard_headers": headers, "shard_proposer_slashings": 1,
            "host_pairings_per_replay": 2 * headers,
            "setup_s": setup_d_s, **line}

        # -- world E: custody_game -----------------------------------------
        we = SPEC_WORLD_E
        t0 = time.perf_counter()
        spec_e, genesis_e, _ = _spec_world(pool, we["fork"], we["preset"],
                                           we["validators"])
        base_e = genesis_e.copy()
        walk_epoch = int(spec_e.EPOCHS_PER_CUSTODY_PERIOD) - 1
        transition_to(spec_e, base_e,
                      walk_epoch * int(spec_e.SLOTS_PER_EPOCH) - 1)
        walk_s = time.perf_counter() - t0
        blocks_e, _, _ = _world_a_blocks(pool, spec_e, base_e,
                                         _custody_reveals(spec_e))
        setup_e_s = time.perf_counter() - t0
        last = blocks_e[-1].message.body
        _check(len(last.custody_key_reveals) > 0
               and len(last.early_derived_secret_reveals) == 1,
               "world E: no reveals in its last block")

        def masked_wrong(block, pre):
            reveal = block.body.early_derived_secret_reveals[0]
            reveal.reveal = spec_e.BLSSignature(pool.sign(
                [(int(reveal.revealed_index) + 1, b"\x5a" * 32)])[0])
        line, world = _fork_world(torch, "world E", spec_e, base_e, blocks_e,
                                  len(blocks_e) - 1, masked_wrong,
                                  "aggregate", 2)
        count(world)
        out["world_e"] = {
            **we, "walked_epochs": walk_epoch, "walk_s": walk_s,
            "custody_key_reveals": len(last.custody_key_reveals),
            "early_derived_secret_reveals": 1, "attestations": sum(
                len(b.message.body.attestations) for b in blocks_e),
            "setup_s": setup_e_s, **line}
    finally:
        bls.bls_active, bls._backend = was
    return {**out, "launches": dict(launches), **card}, launches


# ---------------------------------------------------------------------------
# phase 15: the serve fleet
# ---------------------------------------------------------------------------

FLEET_WORKERS = 2  # the JAX package's fleet smoke count
# the fault part's objective, the fleet smoke's: a flush that falls to the
# pure-Python oracle takes seconds an item, far past it
FLEET_SLO = [{"name": "serve_p99", "label": "serve.submit_to_result",
              "quantile": 99.0, "threshold_s": 0.5}]
# flight events of the degradation ladder and of commanded sheds
_FLEET_LADDER_EVENTS = ("backend_retry", "degraded_rlc_to_groups",
                        "degraded_to_oracle", "device_stage_error",
                        "prep_error", "shed_rung")
_VM_LABEL = re.compile(r"^vm\[steps=(\d+),regs=(\d+),batch=\(([\d, ]*)\),")
_PROGRAM_KEY = re.compile(r"^(\w+)\[k=(\d+),fold=(\d+)\]$")


def _fleet_launch_shapes(snaps, shapes):
    """Note in ``shapes`` (the layout of _recording_launch_shapes) every
    (program, rows) a fleet worker ran the step kernel at: its
    vm[steps=...,regs=...,batch=...] stats matched to the steps and
    registers of the programs it resolved (its snapshot's
    ``extra["programs"]``), each resolved again here through _program,
    from the same .vm_cache_torch/ entry."""
    from consensus_specs_tpu_torch.ops import bls_backend

    for label, snap in snaps.items():
        by_shape = {}
        for key, p in snap["extra"]["programs"].items():
            by_shape.setdefault((p["steps"], p["regs"]), []).append(key)
        for stat in snap["stats"]:
            m = _VM_LABEL.match(stat)
            if m is None:
                continue
            dims = [int(d) for d in m.group(3).replace(" ", "").split(",")
                    if d]
            rows = int(np.prod(dims)) if dims else 1
            keys = by_shape.get((int(m.group(1)), int(m.group(2))))
            _check(keys, f"fleet worker {label}: no program it resolved "
                         f"has the shape of {stat}")
            for key in keys:
                kind, k, fold = _PROGRAM_KEY.match(key).groups()
                prog, got_fold = bls_backend._program(kind, int(k), int(fold))
                shapes.setdefault((id(prog), rows),
                                  (prog, rows, (kind, int(k), got_fold)))


def _fleet_records(router, kinds):
    """The merged journal's events of ``kinds`` and the merged ladder
    stat counts (every live worker polled first)."""
    router.poll_snapshots()
    events = [e for e in router.aggregator.journal_events()
              if e["kind"] in kinds]
    stats = router.aggregator.merged_stats()
    return events, {label: stats.get(label, {}).get("calls", 0)
                    for label in _LADDER}


def _percentile_ms(sorted_s, q):
    """Nearest-rank percentile of sorted seconds, in ms."""
    i = max(0, int(np.ceil(q / 100.0 * len(sorted_s))) - 1)
    return sorted_s[i] * 1e3


def _pool_cover():
    """Checks of COMMITTEE members each that together hold every key of
    phase 4's pool, over messages of their own, validly signed: a
    worker's warm-up to the pubkey cache phase 8's process had."""
    from consensus_specs_tpu_torch.ops.bls_backend import DST
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    _, sks, pks = key_pool()
    starts = list(range(0, KEY_POOL - COMMITTEE, COMMITTEE))
    starts.append(KEY_POOL - COMMITTEE)
    items = []
    for i, lo in enumerate(starts):
        msg = b"fleet warm-up %d" % i + b"\x00" * 16
        agg_sk = sum(sks[lo:lo + COMMITTEE]) % O.R
        sig = O.g2_to_bytes(O.ec_mul(O.hash_to_g2(msg, DST), agg_sk))
        items.append(("fast_aggregate", pks[lo:lo + COMMITTEE], msg, sig))
    return items


def _fleet_stream(torch, router, committees, serve_verdicts, serve_main):
    """Phase 8's main stream (its slot, picks and Poisson gaps, from the
    same seed) routed through the fleet: every verdict the planted one and
    phase 8's, none lost, and no fallback, retry or ladder record in the
    merged journal or stats. Outside the window each worker first
    verifies checks covering the key pool (phase 8's process had every
    pool key decoded by the earlier phases) and the stream's spare
    committee (the serve bench's warm-up)."""
    import concurrent.futures as cf

    from consensus_specs_tpu_torch.serve import load

    rng = random.Random(SEED)
    picks = load._event_schedule(rng, committees, SERVE_EVENTS)
    spare = ([i for i in range(len(committees)) if i not in set(picks)]
             or [0])[0]
    t0 = time.perf_counter()
    warm = _pool_cover() + [("fast_aggregate",) + tuple(committees[spare][:3])]
    want = [True] * (len(warm) - 1) + [bool(committees[spare][3])]
    for label in router.live_workers:
        handle = router.handle(label)
        got = [bool(f.result(timeout=600))
               for f in [handle.submit(*it) for it in warm]]
        _check(got == want, f"fleet warm-up on {label}: verdicts {got}")
    warmup_s = time.perf_counter() - t0
    before = router.poll_snapshots()
    _check(sorted(before) == sorted(router.live_workers)
           and len(before) == FLEET_WORKERS,
           f"fleet stream: snapshots from {sorted(before)}")

    futures, expected, t_sub, done_at = [], [], [], {}
    sig_count = 0
    t_start = time.perf_counter()
    t_next = t_start
    for ci in picks:
        pks, msg, sig, ok = committees[ci]
        t_sub.append(time.perf_counter())
        fut = router.submit("fast_aggregate", pks, msg, sig)
        fut.add_done_callback(
            lambda f, i=len(futures): done_at.__setitem__(
                i, time.perf_counter()))
        futures.append(fut)
        expected.append(bool(ok))
        sig_count += len(pks)
        t_next += rng.expovariate(SERVE_RATE_HZ)
        pause = t_next - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
    _, pending = cf.wait(futures, timeout=600)
    elapsed = time.perf_counter() - t_start
    _check(not pending, f"fleet stream: {len(pending)} of {len(futures)} "
                        "requests never resolved")
    got = [bool(f.result()) for f in futures]
    wrong = [i for i, (g, w) in enumerate(zip(got, expected)) if g != w]
    _check(not wrong, f"fleet stream: events {wrong[:10]} answered wrong")
    differ = [i for i, ci in enumerate(picks) if got[i] != serve_verdicts[ci]]
    _check(not differ, f"fleet stream: events {differ[:10]} differ from "
                       "the single-process stream's verdicts")
    events, ladder = _fleet_records(router, _FLEET_LADDER_EVENTS)
    _check(not events and not any(ladder.values()),
           f"fleet stream: ladder records {ladder}, events {events[:3]}")
    after = {label: router.aggregator.worker_snapshot(label)
             for label in router.live_workers}
    workers = {}
    for label in sorted(after):
        k0, s0 = (before[label]["extra"]["kernels"],
                  before[label]["extra"]["serve"])
        k1, s1 = after[label]["extra"]["kernels"], after[label]["extra"]["serve"]
        flushes = s1["device_flushes"] - s0["device_flushes"]
        preps = s1["prep_batches"] - s0["prep_batches"]
        w = {"submits": s1["submits"] - s0["submits"],
             "cache_hits": s1["cache_hits"] - s0["cache_hits"],
             "inflight_joins": s1["inflight_joins"] - s0["inflight_joins"],
             "flushes": flushes, "prep_batches": preps,
             "prep_ms_per_flush": (s1["prep_ms_total"]
                                   - s0["prep_ms_total"]) / max(1, preps),
             "device_ms_per_flush": (s1["device_ms_total"]
                                     - s0["device_ms_total"]) / max(1, flushes),
             "step_kernel_launches": k1["vm_step"] - k0["vm_step"],
             "step_kernel_steps": k1["vm_step_steps"] - k0["vm_step_steps"],
             "mont_mul_kernel_launches": k1["mont_mul"] - k0["mont_mul"],
             "chain_graph_captures": (k1["mont_mul_captures"]
                                      - k0["mont_mul_captures"]),
             "fallback_items": s1["fallback_items"],
             "backend_retries": s1["backend_retries"],
             "rlc": s1["rlc"]}
        _check(w["fallback_items"] == 0 and w["backend_retries"] == 0,
               f"fleet stream: worker {label} fell back: {w}")
        _check(flushes > 0 and w["step_kernel_launches"] > 0
               and w["mont_mul_kernel_launches"] > 0,
               f"fleet stream: worker {label} flushed {flushes} times with "
               f"kernel launches {w}")
        workers[label] = w
    lat = sorted(done_at[i] - t_sub[i] for i in range(len(futures)))
    verified_keys = sum(len(committees[ci][0]) for ci in set(picks))
    return {"committees": len(committees), "committee_size": COMMITTEE,
            "events": len(picks), "distinct_checks": len(set(picks)),
            "rate_hz": SERVE_RATE_HZ, "max_batch": SERVE_MAX_BATCH,
            "max_wait_ms": SERVE_MAX_WAIT_MS, "workers": FLEET_WORKERS,
            "verdicts_exact": True, "lost": 0, "wrong": 0,
            "equal_to_single_process": True, "ladder_records": ladder,
            "warmup_s": warmup_s, "elapsed_s": elapsed,
            "served_sigs_per_s": sig_count / elapsed,
            "verified_sigs_per_s": verified_keys / elapsed,
            "p50_ms": _percentile_ms(lat, 50), "p95_ms": _percentile_ms(lat, 95),
            "p99_ms": _percentile_ms(lat, 99), "latency_n": len(lat),
            "latency_note": "submit to verdict as the router's caller sees "
                            "it, the worker pipe included",
            "per_worker": workers,
            "single_process": {key: serve_main[key] for key in (
                "served_sigs_per_s", "verified_sigs_per_s", "p50_ms",
                "p95_ms", "p99_ms", "flushes", "prep_ms_per_flush",
                "device_ms_per_flush", "step_kernel_launches",
                "mont_mul_kernel_launches")}}


def _fleet_affinity(router, items, want):
    """Phase 11's mainnet slot (64 committees of 512, the planted bad
    committee) routed twice through CommitteeFleet on the same workers:
    verify_slot's verdicts both rounds, a stable assignment, 0 moves and
    no ladder record."""
    from consensus_specs_tpu_torch.scale.routing import CommitteeFleet

    fleet = CommitteeFleet(router=router)
    assign = fleet.assignment(range(len(items)))
    walls = []
    for rnd in range(2):
        t0 = time.perf_counter()
        got = fleet.submit_slot(items, timeout=600)
        walls.append(time.perf_counter() - t0)
        _check(got == want, f"fleet affinity round {rnd}: committees "
               f"{[i for i, (g, w) in enumerate(zip(got, want)) if g != w]} "
               "differ from verify_slot's verdicts")
    _check(fleet.assignment(range(len(items))) == assign,
           "fleet affinity: the committee->worker assignment drifted")
    _check(fleet.affinity_moves == 0,
           f"fleet affinity: {fleet.affinity_moves} moves on a stable ring")
    events, ladder = _fleet_records(router, _FLEET_LADDER_EVENTS)
    _check(not events and not any(ladder.values()),
           f"fleet affinity: ladder records {ladder}, events {events[:3]}")
    per_worker = {}
    for ci, label in assign.items():
        per_worker[label] = per_worker.get(label, 0) + 1
    return {"committees": len(items), "committee_size": len(items[0][1]),
            "bad_committees": [i for i, w in enumerate(want) if not w],
            "verdicts_equal_verify_slot": True, "rounds": 2,
            "round_walls_s": walls, "committees_per_worker": per_worker,
            "committees_routed": fleet.committees_routed,
            "affinity_moves": fleet.affinity_moves,
            "atts_per_s_first_round": sum(len(it[1]) for it in items)
            / walls[0]}


def phase_fleet(torch, card, serve_input, serve_main, mainnet_slot):
    """The serve fleet on the card, bls workers: (a) the port's fleet
    smoke (both phases), then on a fleet at the serve knobs (b) phase 8's
    stream, (d) phase 11's slot by committee affinity, and (c) one worker
    armed to fail until the router sheds or drains it (ladder records
    expected there, and only there). Every worker must run on the card,
    name it, and launch both kernels; its final snapshot feeds the
    launch counts and the launch shapes."""
    from consensus_specs_tpu_torch.obs.slo import ShedPolicy
    from consensus_specs_tpu_torch.serve import fleet_smoke
    from consensus_specs_tpu_torch.serve.fleet import FleetRouter

    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    smoke_report = {}
    rc = fleet_smoke.main(device="cuda", report=smoke_report)
    _check(rc == 0, "fleet smoke failed (its line above says why)")
    smoke = dict(smoke_report["result"], wall_s=time.perf_counter() - t0)
    final = {f"smoke.{label}": snap
             for label, snap in smoke_report["snapshots"].items()}

    t0 = time.perf_counter()
    os.environ["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"  # the router journals
    router = FleetRouter(
        workers=FLEET_WORKERS, backend="bls",
        env={"SERVE_MAX_BATCH": str(SERVE_MAX_BATCH),
             "SERVE_MAX_WAIT_MS": str(SERVE_MAX_WAIT_MS),
             "CONSENSUS_SPECS_TPU_FLIGHT": "1"},
        objectives=FLEET_SLO, policy=ShedPolicy())
    try:
        spawn_s = time.perf_counter() - t0
        stream = _fleet_stream(torch, router, serve_input["committees"],
                               serve_input["verdicts"], serve_main)
        items, want = mainnet_slot
        affinity = _fleet_affinity(router, items, want)
        _check(len(router.live_workers) == FLEET_WORKERS,
               f"fleet: live workers {router.live_workers}")
        fleet_smoke.check_worker_devices(router.poll_snapshots(), cuda)
        # (c) baseline the burn windows on everything so far, then fault
        router.control_tick()
        fault = fleet_smoke.fault_decision(router, first_tag=500)
        router.poll_snapshots()
        final.update({label: router.aggregator.worker_snapshot(label)
                      for label in router.aggregator.workers})
    finally:
        router.close()
    fleet_smoke.check_worker_devices(final, cuda)
    launches = {"vm_step": 0, "vm_step_steps": 0, "mont_mul": 0}
    for snap in final.values():
        kernels = snap["extra"]["kernels"]
        for key in launches:
            launches[key] += kernels[key]
    shapes = {}
    _fleet_launch_shapes(final, shapes)
    return {"phase": "fleet", "workers": FLEET_WORKERS,
            "smoke": smoke, "spawn_s": spawn_s, "stream": stream,
            "affinity": affinity,
            "fault": {key: fault[key] for key in (
                "target", "decision", "burn", "objective", "window",
                "fault_items", "ladder_events", "scrape_observations")},
            "fault_note": "this part falls back on purpose",
            "worker_kernels": {label: snap["extra"]["kernels"]
                               for label, snap in final.items()},
            "worker_device_names": sorted({snap["extra"]["device_name"]
                                           for snap in final.values()}),
            "step_kernel_launches": launches["vm_step"],
            "mont_mul_kernel_launches": launches["mont_mul"],
            **card}, launches, shapes


# ---------------------------------------------------------------------------
# phase 16: the light-client proof plane at full width
# ---------------------------------------------------------------------------

LIGHTCLIENT_VALIDATORS = 300_000  # BASELINE.json's registry
# distinct head slots (R): the artifacts built; one since phase 18 joined
# the smoke (each slot's fresh decode and root costs ~17-36 s)
LIGHTCLIENT_SLOTS = 1
LIGHTCLIENT_REQUESTS = 100_000  # client requests (N), the R builds included
LIGHTCLIENT_THREADS = 4  # request threads, as the JAX proofs bench
LIGHTCLIENT_SEED = SEED + 3  # the sync committee's secret keys


def _proof_requests(spec, service, head_slots, roots, build, n, threads):
    """``n`` client requests round-robin over ``head_slots`` from
    ``threads`` request threads, each paying the client's finality-branch
    check against the requested state root (bench/proofs.py's replay).
    Returns (requests checked, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from consensus_specs_tpu_torch.lightclient.proof_tree import (
        floorlog2, subtree_index,
    )

    def one_request(i):
        slot = head_slots[i % len(head_slots)]
        artifact = service.serve(slot, roots[slot], lambda: build(slot))
        g = artifact.finality_gindex
        return bool(artifact.verified is True and spec.is_valid_merkle_branch(
            spec.Root(artifact.finalized_root),
            [spec.Bytes32(b) for b in artifact.finality_branch],
            floorlog2(g), subtree_index(g), spec.Root(roots[slot])))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        checked = sum(pool.map(one_request, range(n), chunksize=256))
    return checked, time.perf_counter() - t0


def phase_lightclient(torch, pool, card):
    """The light-client proof plane on the port's own altair mainnet spec:
    a ProofWorld of the full 512-seat sync committee (keys derived in
    ``pool``) over a registry of 300,000 validators; 2 head slots behind
    one ProofService whose verifier is a VerificationService on the card
    at the serve knobs. Each artifact is built and its sync-committee
    signature verified by the service (FastAggregateVerify k512 on the
    card), then checked in full before the timed window: the spec's
    validate_light_client_update (the switchboard on the card), the
    combined multiproof, and the finality branch against a state
    re-Merkleized from a fresh decode_bytes. Then 100,000 requests (the 2
    builds among them) round-robin from 4 threads, each paying the
    client's is_valid_merkle_branch. Planted controls: an artifact signed
    under a wrong key (verified False, validate_light_client_update
    raises) and a flipped finality-branch byte. Then the port's proof
    smoke (minimal, 32 seats) on 2 bls workers on the card. No fallback,
    retry or ladder record may appear."""
    from consensus_specs_tpu_torch import builder
    from consensus_specs_tpu_torch.lightclient import proof_smoke
    from consensus_specs_tpu_torch.lightclient.proof_tree import (
        ProofWorld, build_update_artifact, floorlog2, subtree_index,
        verify_artifact,
    )
    from consensus_specs_tpu_torch.lightclient.serve_proofs import (
        ProofService,
    )
    from consensus_specs_tpu_torch.obs import latency
    from consensus_specs_tpu_torch.ops import (bls_backend, cuda_fq,
                                               cuda_step, profiling)
    from consensus_specs_tpu_torch.serve.service import VerificationService
    from consensus_specs_tpu_torch.utils import bls
    from consensus_specs_tpu_torch.utils.bls12_381 import R

    bls.use_gpu()  # the spec's own checks on the card
    t0 = time.perf_counter()
    spec = builder.build_spec_module("altair", "mainnet")
    seats = int(spec.SYNC_COMMITTEE_SIZE)
    _check(seats == 512, f"altair mainnet sync committee of {seats} seats")
    rng = np.random.default_rng(LIGHTCLIENT_SEED)
    sks = [int.from_bytes(rng.bytes(32), "little") % (R - 1) + 1
           for _ in range(seats)]
    pks = pool.sk_to_pk(sks)
    _check(all(bls.SkToPk(sks[i]) == pks[i] for i in (0, seats - 1)),
           "lightclient: the key pool's pubkeys differ from SkToPk's")
    keys_s = time.perf_counter() - t0
    world = ProofWorld(spec, sks=sks, pubkeys=pks,
                       validators=LIGHTCLIENT_VALIDATORS)
    world_s = time.perf_counter() - t0 - keys_s
    head_slots = [world.finalized_slot + 1 + i
                  for i in range(LIGHTCLIENT_SLOTS)]
    states = {s: world.head_state(s) for s in head_slots}
    roots = {s: bytes(states[s].hash_tree_root()) for s in head_slots}
    setup_s = time.perf_counter() - t0

    def build(slot, sign=world.sign):
        return build_update_artifact(
            spec, states[slot], world.finalized_state,
            genesis_validators_root=world.genesis_validators_root,
            sign=sign)

    def wrong_key(root):
        return [True] * seats, bls.Sign((sum(sks) + 1) % R, bytes(root))

    profiling.reset()
    latency.reset()
    bls_backend.reset_call_counts()
    bls_backend.reset_prep_state()
    cuda_step.LAUNCHES = cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = cuda_fq.CAPTURES = 0
    step_ms = []  # every step-kernel call of the main run (CUDA events)
    t_main = time.perf_counter()
    with _patched(cuda_step, "run_steps", _device_timer(torch, step_ms)):
        verifier = VerificationService(max_batch=SERVE_MAX_BATCH,
                                       max_wait_ms=SERVE_MAX_WAIT_MS)
        try:
            service = ProofService(verifier=verifier)
            slots, artifacts = [], {}
            for s in head_slots:
                tb = time.perf_counter()
                artifact = service.serve(s, roots[s], lambda s=s: build(s))
                build_s = time.perf_counter() - tb
                artifacts[s] = artifact
                _check(artifact.verified is True,
                       f"lightclient slot {s}: the card service's verdict is "
                       f"{artifact.verified!r}")
                _check(len(artifact.participant_pubkeys) == seats,
                       f"lightclient slot {s}: "
                       f"{len(artifact.participant_pubkeys)} participants")
                td = time.perf_counter()
                fresh = spec.BeaconState.decode_bytes(states[s].encode_bytes())
                fresh_root = bytes(fresh.hash_tree_root())
                decode_s = time.perf_counter() - td
                _check(fresh_root == roots[s], f"lightclient slot {s}: the "
                       "re-Merkleized root differs from the served one")
                del fresh
                tv = time.perf_counter()
                verify_artifact(spec, artifact, world.snapshot,
                                world.genesis_validators_root,
                                state_root=fresh_root)
                verify_s = time.perf_counter() - tv
                slots.append({"slot": s, "build_and_card_verdict_s": build_s,
                              "fresh_decode_and_root_s": decode_s,
                              "client_verify_s": verify_s,
                              "multiproof_nodes": len(artifact.multi_proof),
                              "finality_branch":
                                  len(artifact.finality_branch)})

            # planted controls, outside the served cache's accounting
            controls = ProofService(verifier=verifier)
            s = head_slots[0]
            bad = controls.serve(s, roots[s], lambda: build(s, sign=wrong_key))
            _check(bad.verified is False,
                   "lightclient: an update signed under "
                   f"a wrong key came back verified={bad.verified!r}")
            try:
                spec.validate_light_client_update(
                    world.snapshot, bad.update,
                    spec.Root(world.genesis_validators_root))
            except AssertionError:
                pass
            else:
                raise SmokeFailure("lightclient: validate_light_client_update "
                                   "accepted an update signed under a "
                                   "wrong key")
            good = artifacts[s]
            g = good.finality_gindex
            flipped = [bytes(b) for b in good.finality_branch]
            flipped[0] = bytes([flipped[0][0] ^ 1]) + flipped[0][1:]
            _check(not spec.is_valid_merkle_branch(
                spec.Root(good.finalized_root),
                [spec.Bytes32(b) for b in flipped], floorlog2(g),
                subtree_index(g), spec.Root(roots[s])),
                "lightclient: a flipped finality-branch byte still verified")

            window = LIGHTCLIENT_REQUESTS - LIGHTCLIENT_SLOTS
            checked, elapsed = _proof_requests(
                spec, service, head_slots, roots, build, window,
                LIGHTCLIENT_THREADS)
            _check(checked == window,
                   f"lightclient: {window - checked} requests failed the "
                   "check")
            vsnap = verifier.metrics.snapshot()
        finally:
            verifier.close(timeout=60)
    main_s = time.perf_counter() - t_main
    launches = {"vm_step": cuda_step.LAUNCHES,
                "vm_step_steps": cuda_step.STEPS,
                "mont_mul": cuda_fq.LAUNCHES}
    snap = service.snapshot()
    _check(snap["served"] == LIGHTCLIENT_REQUESTS
           and snap["builds"] == LIGHTCLIENT_SLOTS
           and snap["cache_hits"] + snap["inflight_joins"]
           == LIGHTCLIENT_REQUESTS - LIGHTCLIENT_SLOTS,
           f"lightclient: cache accounting {snap}")
    hit_rate = service.metrics.hit_rate
    _check(hit_rate == (LIGHTCLIENT_REQUESTS - LIGHTCLIENT_SLOTS)
           / LIGHTCLIENT_REQUESTS, f"lightclient: hit rate {hit_rate}")
    ladder = _ladder_records()
    for key in ("fallback_items", "backend_retries", "mesh_fallbacks"):
        _check(vsnap[key] == 0, f"lightclient: {key} = {vsnap[key]}")
    _check(not any(ladder.values()), f"lightclient: ladder records {ladder}")
    _check(launches["vm_step"] > 0 and launches["mont_mul"] > 0,
           f"lightclient: kernel launches {launches}")
    serve_lat = latency.snapshot().get(latency.stage_label("proof_serve"), {})

    # the proof smoke: 2 bls workers on the card
    t0 = time.perf_counter()
    smoke_report = {}
    rc = proof_smoke.main(device="cuda", report=smoke_report)
    _check(rc == 0, "proof smoke failed (its line above says why)")
    smoke_s = time.perf_counter() - t0
    snaps = smoke_report["snapshots"]
    workers = {label: snap["extra"]["kernels"] for label, snap in
               snaps.items()}
    # this process's launches through the proof smoke too (its client
    # checks on the card), then each worker's own count from 0
    total = {"vm_step": cuda_step.LAUNCHES, "vm_step_steps": cuda_step.STEPS,
             "mont_mul": cuda_fq.LAUNCHES}
    for kernels in workers.values():
        for key in total:
            total[key] += kernels[key]
    shapes = {}
    _fleet_launch_shapes(snaps, shapes)
    return {"phase": "lightclient", "fork": "altair", "preset": "mainnet",
            "seats": seats, "validators": LIGHTCLIENT_VALIDATORS,
            "slots": LIGHTCLIENT_SLOTS, "requests": LIGHTCLIENT_REQUESTS,
            "threads": LIGHTCLIENT_THREADS,
            "max_batch": SERVE_MAX_BATCH, "max_wait_ms": SERVE_MAX_WAIT_MS,
            "setup_s": setup_s, "keys_s": keys_s, "world_s": world_s,
            "per_slot": slots, "main_s": main_s,
            "artifacts_verified": True, "controls_flagged": [
                "wrong_key_signature", "flipped_finality_branch_byte"],
            "window_requests": window, "window_s": elapsed,
            "proofs_served_per_s": window / elapsed,
            "hit_rate": hit_rate, "service": snap,
            "proof_serve_p50_ms": serve_lat.get("p50_ms"),
            "proof_serve_p99_ms": serve_lat.get("p99_ms"),
            "proof_serve_n": serve_lat.get("n"),
            "verifier": {key: vsnap[key] for key in (
                "batches", "device_flushes", "fallback_items",
                "backend_retries", "mesh_fallbacks", "rlc")},
            "ladder_records": ladder,
            "prep": dict(bls_backend.PREP_STATS),
            "step_kernel_launches": launches["vm_step"],
            "step_kernel_steps": launches["vm_step_steps"],
            "mont_mul_kernel_launches": launches["mont_mul"],
            "step_kernel_ms": sum(step_ms),
            "step_kernel_busy_share": sum(step_ms) / 1e3 / main_s,
            "proof_smoke": dict(smoke_report["result"], wall_s=smoke_s,
                                worker_kernels=workers),
            "path_launches": total,
            **card}, total, shapes


# ---------------------------------------------------------------------------
# phase 17: the simnet
# ---------------------------------------------------------------------------

SIM_FLEET_WORKERS = 2


def phase_sim(torch, card):
    """The port's simnet, every node's service on the card over the
    crypto-free VerdictBackend: sim/smoke.main (partition_heal, 4 nodes,
    strict gate), every scenario of the library under the strict gate,
    partition_heal replayed on 2 verdict worker processes on the card
    (each reporting the card as its device), and sim/latency_smoke.main.
    It launches no kernel, by the JAX package's own design (the simnet's
    verdicts ride in the signature bytes)."""
    from consensus_specs_tpu_torch import sim
    from consensus_specs_tpu_torch.ops import cuda_fq, cuda_step
    from consensus_specs_tpu_torch.sim import latency_smoke, smoke
    from consensus_specs_tpu_torch.sim.fleet_replay import run_fleet_replay

    cuda_step.LAUNCHES = cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = cuda_fq.CAPTURES = 0
    t0 = time.perf_counter()
    report = {}
    _check(smoke.main(report=report) == 0,
           "sim smoke failed (its line above says why)")
    smoke_run = report["scenario"]
    smoke_s = time.perf_counter() - t0

    def evidence(r):
        return {"converged": r.converged, "digest": r.digest,
                "head": r.head, "head_slot": r.head_slot,
                "heal_to_convergence_s": r.heal_to_convergence_s,
                "deliveries": r.deliveries,
                "diverged_samples": r.diverged_samples,
                "light_clients": r.light_clients,
                "proofs_served": r.proofs_served,
                "proofs_verified": r.proofs_verified,
                "proof_failures": r.proof_failures,
                "proof_cache_hit_rate": r.proof_cache_hit_rate,
                "wall_s": r.wall_s}

    spec, anchor_state, anchor_block = sim.build_world()
    library = {}
    for name in sim.scenario_names():
        r = sim.run_scenario(
            sim.get_scenario(name), spec=spec, anchor_state=anchor_state,
            anchor_block=anchor_block, seed=7, strict=True)
        _check(r.converged and r.proofs_verified > 0
               and r.proof_failures == 0,
               f"sim {name}: {r.error or 'no verified light-client proof'}")
        library[name] = evidence(r)
    _check(library["partition_heal"]["digest"] == smoke_run.digest,
           "sim: the smoke's partition_heal digest differs from the "
           "library run's at the same seed")

    t0 = time.perf_counter()
    replay = run_fleet_replay("partition_heal", workers=SIM_FLEET_WORKERS)
    replay_s = time.perf_counter() - t0
    per_worker = replay["fleet"]["per_worker"]
    _check(replay["report"].converged
           and len(per_worker) == SIM_FLEET_WORKERS
           and sum(w["submits"] for w in per_worker.values()) > 0,
           f"sim fleet replay: {replay['fleet']}")
    names = {w["device_name"] for w in per_worker.values()}
    _check({w["device"] for w in per_worker.values()} == {"cuda"}
           and names == {torch.cuda.get_device_name(0)},
           f"sim fleet replay: workers on {per_worker}")
    _check(replay["report"].digest == library["partition_heal"]["digest"],
           "sim fleet replay: its digest differs from the in-process run's")

    t0 = time.perf_counter()
    _check(latency_smoke.main() == 0,
           "sim latency smoke failed (its line above says why)")
    latency_s = time.perf_counter() - t0
    launches = {"vm_step": cuda_step.LAUNCHES,
                "vm_step_steps": cuda_step.STEPS,
                "mont_mul": cuda_fq.LAUNCHES}
    _check(launches == {"vm_step": 0, "vm_step_steps": 0, "mont_mul": 0},
           f"sim: kernel launches {launches} on a crypto-free path")
    return {"phase": "sim", "nodes": smoke_run.nodes, "seed": 7,
            "smoke": dict(evidence(smoke_run), wall_s=smoke_s),
            "library": library,
            "fleet_replay": dict(evidence(replay["report"]),
                                 wall_s=replay_s, per_worker=per_worker,
                                 routed=replay["fleet"]["routed"]),
            "latency_smoke_s": latency_s,
            "kernels_note": "no kernel by design: the simnet's services "
                            "answer through the crypto-free VerdictBackend",
            "step_kernel_launches": 0, "mont_mul_kernel_launches": 0,
            **card}, launches


# ---------------------------------------------------------------------------
# phase 18: the spec tests' @always_bls cases, signatures on the card
# ---------------------------------------------------------------------------

# the JAX package's @always_bls uses under consensus_specs_tpu/test/<fork>
# (tests/test_torch_spec_harness.py holds the port's pick against them);
# merge's spec tests have none
SPEC_TESTS_CASES = {"phase0": 50, "altair": 22}
SPEC_TESTS_PRESET = "minimal"
_CARD_CALLS = {"verify": "oracle_verify",
               "fast_aggregate_verify": "oracle_fast_aggregate_verify",
               "aggregate_verify": "oracle_aggregate_verify"}
_HOST_SIGNING = ("Sign", "Aggregate", "SkToPk")


def spec_test_cases():
    """(fork, module, name, function) of every ``@always_bls`` case of the
    port's spec tests of each fork of SPEC_TESTS_CASES, in module order;
    a case runs on the fork of its package."""
    import importlib
    import pkgutil

    from consensus_specs_tpu_torch.test.harness import always_bls_names

    cases = []
    for fork in SPEC_TESTS_CASES:
        package = importlib.import_module(f"consensus_specs_tpu_torch.test.{fork}")
        for info in pkgutil.walk_packages(package.__path__,
                                          package.__name__ + "."):
            module = importlib.import_module(info.name)
            rel = info.name[len(package.__name__) + 1:]
            cases += [(fork, rel, name, getattr(module, name))
                      for name in always_bls_names(module)]
    return cases


def phase_spec_tests(torch, card):
    """The ``@always_bls`` phase0 and altair cases of the port on the
    card, through the harness's case runner (generator mode, each on its
    fork, minimal). Counts every card call of the switchboard
    (ops/bls_backend's verify, fast_aggregate_verify, aggregate_verify)
    with its verdict and any exception, every call of the oracle's verify
    functions (there must be none), and the kernels' launches; times host
    signing and card calls; splits calls, verdicts and times by fork.
    Fails on a case that does not pass, an oracle call, a card exception
    other than a decode error on an input the oracle also rejects, a fork
    with no card call, or a kernel that was never launched."""
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_fq, cuda_step
    from consensus_specs_tpu_torch.test.harness import run_case
    from consensus_specs_tpu_torch.utils import bls

    cases = spec_test_cases()
    found = {fork: sum(c[0] == fork for c in cases) for fork in SPEC_TESTS_CASES}
    _check(found == SPEC_TESTS_CASES,
           f"spec_tests: @always_bls cases by fork {found}, not "
           f"{SPEC_TESTS_CASES}")
    by_fork = {fork: {"calls": {f: 0 for f in _CARD_CALLS},
                      "verdicts": {"true": 0, "false": 0},
                      "card_s": [], "sign_s": [], "wall_s": 0.0}
               for fork in SPEC_TESTS_CASES}
    oracle_calls = {f: 0 for f in _CARD_CALLS.values()}
    raised = []
    current = {}  # the running case's fork's entry of by_fork

    def card_call(fname):
        def wrap(fn):
            def counted(*args, **kwargs):
                current["calls"][fname] += 1
                t = time.perf_counter()
                try:
                    ok = fn(*args, **kwargs)
                except Exception as exc:
                    raised.append((fname, type(exc).__name__, str(exc), args))
                    raise
                finally:
                    current["card_s"].append(time.perf_counter() - t)
                current["verdicts"]["true" if ok else "false"] += 1
                return ok
            return counted
        return wrap

    def sign_timer(fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                current["sign_s"].append(time.perf_counter() - t)
        return timed

    def oracle_call(fname):
        def wrap(fn):
            def counted(*args, **kwargs):
                oracle_calls[fname] += 1
                return fn(*args, **kwargs)
            return counted
        return wrap

    saved_backend = bls._backend
    bls.use_gpu()
    outcomes, case_s = {}, {}
    cuda_step.LAUNCHES = cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = cuda_fq.CAPTURES = 0
    try:
        with contextlib.ExitStack() as stack:
            for fname, oname in _CARD_CALLS.items():
                stack.enter_context(
                    _patched(bls_backend, fname, card_call(fname)))
                stack.enter_context(_patched(bls, oname, oracle_call(oname)))
            for fname in _HOST_SIGNING:
                stack.enter_context(_patched(bls, fname, sign_timer))
            t0 = time.perf_counter()
            for fork, rel, name, fn in cases:
                current.update(by_fork[fork])
                key = f"{fork}.{rel}::{name}"
                t = time.perf_counter()
                outcomes[key] = run_case(fn, fork, SPEC_TESTS_PRESET,
                                         False)[0]
                case_s[key] = time.perf_counter() - t
                by_fork[fork]["wall_s"] += case_s[key]
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        bls._backend = saved_backend
    launches = {"vm_step": cuda_step.LAUNCHES,
                "vm_step_steps": cuda_step.STEPS,
                "mont_mul": cuda_fq.LAUNCHES}
    # after the span, so these oracle calls are not counted: a decode
    # error passes only on an input the oracle rejects too
    oracle = {f: getattr(bls, o) for f, o in _CARD_CALLS.items()}
    unexpected = [(f, kind, msg) for f, kind, msg, args in raised
                  if kind not in ("ValueError", "TypeError")
                  or oracle[f](*args)]
    failed = {k: v for k, v in outcomes.items() if v != "parts"}
    _check(not failed, f"spec_tests: cases that did not pass: {failed}")
    _check(not any(oracle_calls.values()),
           f"spec_tests: the oracle verified on the card's path: "
           f"{oracle_calls}")
    _check(not unexpected,
           f"spec_tests: card calls raised {unexpected}")
    calls = {f: sum(c["calls"][f] for c in by_fork.values())
             for f in _CARD_CALLS}
    _check(all(sum(c["calls"].values()) > 0 for c in by_fork.values())
           and launches["vm_step"] > 0 and launches["mont_mul"] > 0,
           f"spec_tests: card calls {calls}, launches {launches}")
    forks = {fork: {"cases": SPEC_TESTS_CASES[fork],
                    "card_calls": c["calls"], "verdicts": c["verdicts"],
                    "wall_s": c["wall_s"], "host_sign_s": sum(c["sign_s"]),
                    "card_call_s": sum(c["card_s"])}
             for fork, c in by_fork.items()}
    sign_s = sum(f["host_sign_s"] for f in forks.values())
    card_s = sum(f["card_call_s"] for f in forks.values())
    slowest = sorted(case_s.items(), key=lambda kv: -kv[1])[:3]
    return {"phase": "spec_tests", "cases": len(cases),
            "preset": SPEC_TESTS_PRESET, "passed": len(outcomes),
            "card_calls": calls,
            "verdicts": {v: sum(f["verdicts"][v] for f in forks.values())
                         for v in ("true", "false")},
            "by_fork": forks,
            "card_exceptions": [(f, kind) for f, kind, _, _ in raised],
            "oracle_calls": oracle_calls,
            "wall_s": wall, "host_sign_s": sign_s, "card_call_s": card_s,
            "other_s": wall - sign_s - card_s,
            "slowest_cases_s": slowest,
            "step_kernel_launches": launches["vm_step"],
            "step_kernel_steps": launches["vm_step_steps"],
            "mont_mul_kernel_launches": launches["mont_mul"],
            **card}, launches


# ---------------------------------------------------------------------------
# phase 19: the test-vector generators, the bls generator's checks on the card
# ---------------------------------------------------------------------------

GEN_BLS_CASES = 29
GEN_CHECKS = {"verify": 6, "fast_aggregate_verify": 6, "aggregate_verify": 3}
GEN_HOST_ANSWERED = 3  # two empty pubkey lists, one length mismatch
# the generators run on the card's host alone, and their CLI selections
GEN_HOST_TREES = (("ssz_generic", "ssz_generic", []),
                  ("shuffling -l minimal", "shuffling", ["-l", "minimal"]),
                  ("merkle -l minimal", "merkle", ["-l", "minimal"]))


def _gen_tree(name, args, out_dir):
    """Run one generator of the port into ``out_dir`` (its per-case prints
    kept off stdout): (rc, its summary line, seconds)."""
    import importlib
    import io

    gen = importlib.import_module(
        f"consensus_specs_tpu_torch.gen.generators.{name}")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = gen.main(["-o", out_dir] + args)
    summary = [ln for ln in buf.getvalue().splitlines() if "collected=" in ln]
    return rc, summary[-1] if summary else "", time.perf_counter() - t


def phase_gen(torch, card):
    """The port's ``bls`` generator with every cross-check on the card,
    then the host generators; see the module docstring, phase 19."""
    import tempfile

    from consensus_specs_tpu_torch.gen import digests, gen_runner
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_fq, cuda_step
    from consensus_specs_tpu_torch.utils import bls

    calls = []  # (kind, host answered, verdict, step launches, mont launches, s)
    raised = []
    oracle_calls = {o: 0 for o in _CARD_CALLS.values()}
    inside = []

    def card_call(fname):
        def wrap(fn):
            def counted(*args, **kwargs):
                pks = args[0]
                host = len(pks) == 0 or (fname == "aggregate_verify"
                                         and len(pks) != len(args[1]))
                steps0, mont0 = cuda_step.LAUNCHES, cuda_fq.LAUNCHES
                t = time.perf_counter()
                inside.append(fname)
                try:
                    ok = fn(*args, **kwargs)
                except Exception as exc:
                    raised.append((fname, type(exc).__name__, str(exc)))
                    raise
                finally:
                    inside.pop()
                torch.cuda.synchronize()
                calls.append((fname, host, bool(ok),
                               cuda_step.LAUNCHES - steps0,
                               cuda_fq.LAUNCHES - mont0,
                               time.perf_counter() - t))
                return ok
            return counted
        return wrap

    def oracle_call(oname):
        def wrap(fn):
            def counted(*args, **kwargs):
                if inside:
                    oracle_calls[oname] += 1
                return fn(*args, **kwargs)
            return counted
        return wrap

    saved = (bls._backend, bls.bls_active)
    cuda_step.LAUNCHES = cuda_step.STEPS = 0
    cuda_fq.LAUNCHES = cuda_fq.CAPTURES = 0
    trees = {}
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.ExitStack() as stack:
            for fname, oname in _CARD_CALLS.items():
                stack.enter_context(
                    _patched(bls_backend, fname, card_call(fname)))
                stack.enter_context(_patched(bls, oname, oracle_call(oname)))
            bls_dir = os.path.join(tmp, "bls")
            rc, summary, wall = _gen_tree("bls", [], bls_dir)
        torch.cuda.synchronize()
        launches = {"vm_step": cuda_step.LAUNCHES,
                    "vm_step_steps": cuda_step.STEPS,
                    "mont_mul": cuda_fq.LAUNCHES}
        restored = (bls._backend, bls.bls_active) == saved
        cases = [d for d, _, files in os.walk(bls_dir) if "data.yaml" in files]
        incomplete = gen_runner.detect_incomplete(bls_dir)
        error_log = os.path.exists(os.path.join(bls_dir, gen_runner.ERROR_LOG))
        trees["bls"] = {"rc": rc, "summary": summary, "s": wall,
                        "digest": digests.tree_digest(bls_dir)}
        for key, name, args in GEN_HOST_TREES:
            out_dir = os.path.join(tmp, key.replace(" ", "_"))
            rc_h, summary_h, s_h = _gen_tree(name, args, out_dir)
            trees[key] = {"rc": rc_h, "summary": summary_h, "s": s_h,
                          "digest": digests.tree_digest(out_dir)}

    by_kind = {k: sum(c[0] == k for c in calls) for k in GEN_CHECKS}
    on_card = [c for c in calls if not c[1]]
    host = [c for c in calls if c[1]]
    _check(rc == 0 and len(cases) == GEN_BLS_CASES and not incomplete
           and not error_log,
           f"gen: bls rc {rc}, {len(cases)} cases of {GEN_BLS_CASES}, "
           f"INCOMPLETE {incomplete}, error log {error_log}: {summary}")
    _check(by_kind == GEN_CHECKS and len(host) == GEN_HOST_ANSWERED,
           f"gen: checks {by_kind} ({len(host)} answered on the host), not "
           f"{GEN_CHECKS} ({GEN_HOST_ANSWERED})")
    _check(not raised, f"gen: card calls raised {raised}")
    _check(not any(oracle_calls.values()),
           f"gen: the oracle verified inside the backend: {oracle_calls}")
    _check(all(c[3] == 0 and c[4] == 0 for c in host),
           f"gen: a call answered on the host launched a kernel: {host}")
    _check(restored, f"gen: switchboard {(bls._backend, bls.bls_active)} "
                     f"not restored to {saved}")
    wrong = {k: t["digest"] for k, t in trees.items()
             if t["rc"] != 0 or t["digest"] != digests.PINNED[k]}
    _check(not wrong, f"gen: trees unequal to the pinned digests: {wrong}")
    _check(launches["vm_step"] > 0 and launches["mont_mul"] > 0,
           f"gen: launches {launches}")
    card_s = sum(c[5] for c in on_card)
    return {"phase": "gen", "bls_cases": len(cases),
            "checks": by_kind, "card_calls": len(on_card),
            "host_answered": len(host),
            "verdicts": {"true": sum(c[2] for c in calls),
                         "false": sum(not c[2] for c in calls)},
            "card_exceptions": len(raised), "oracle_calls": oracle_calls,
            "calls": [{"kind": c[0], "verdict": c[2], "vm_step": c[3],
                       "mont_mul": c[4], "s": c[5]} for c in on_card],
            "bls_wall_s": wall, "card_call_s": card_s,
            "host_s": wall - card_s,
            "trees": trees,
            "step_kernel_launches": launches["vm_step"],
            "step_kernel_steps": launches["vm_step_steps"],
            "mont_mul_kernel_launches": launches["mont_mul"],
            **card}, launches


# phase 20's modes of the bench entry, in order, with the knobs each runs
# at (committee and the epoch at full width; the rest cut to fit the phase)
BENCH_MODES = (
    ("committee", {"BENCH_N": "32", "BENCH_K": "128", "BENCH_REPS": "3"}),
    ("epoch", {"BENCH_REPS": "1"}),  # the mainnet shape is the card default
    ("codec", {"CODEC_ITEMS": "64"}),
    ("rlc", {"RLC_BENCH_NS": "4,16,64"}),
    ("head", {}),
    # the censored simnet section at 256 validators: at its default 2,048
    # the simnet's host fork choice took ~130 s of the mode
    ("mainnet", {"CONSENSUS_SPECS_TPU_SCALE_VALIDATORS": "262144",
                 "CONSENSUS_SPECS_TPU_SCALE_SLOTS": "1",
                 "CONSENSUS_SPECS_TPU_SCALE_FLEET_WORKERS": "2",
                 "CONSENSUS_SPECS_TPU_SCALE_SIM_VALIDATORS": "256"}),
    ("serve", {}),
    ("serve-fleet", {"SERVE_FLEET_WORKERS": "1,2"}),
    ("latency", {}),
    ("soak", {"CONSENSUS_SPECS_TPU_SOAK_EPOCHS": "8",
              "CONSENSUS_SPECS_TPU_SOAK_WORKERS": "2"}),
    ("merkle", {"CONSENSUS_SPECS_TPU_MERKLE_VALIDATORS": "4096"}),
    ("proofs", {"CONSENSUS_SPECS_TPU_PROOF_CLIENTS": "10000",
                "CONSENSUS_SPECS_TPU_PROOF_SLOTS": "2",
                "CONSENSUS_SPECS_TPU_PROOF_VALIDATORS": "4096"}),
    ("sim", {}),
)


@contextlib.contextmanager
def _env(knobs):
    """Set environment variables for the duration."""
    was = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in was.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bench_gates(mode, line):
    """The gate flags of one mode's line: each must be True."""
    gates = {"no_error": "error" not in line}
    if mode == "committee":
        gates["verdicts"] = line.get("verdicts_ok") is True
    elif mode == "epoch":
        gates["verdicts"] = line.get("checks", 0) > 0
    elif mode == "codec":
        gates["outputs_match"] = line.get("outputs_match") is True
    elif mode == "rlc":
        stats = line.get("rlc_stats", {})
        gates["no_bisection"] = stats.get("bisections", 1) == 0
    elif mode == "head":
        gates["heads_match"] = all(t["heads_match"]
                                   for t in line.get("trees", [{}]))
    elif mode in ("mainnet", "merkle"):
        gates["ok"] = line.get("ok") is True
    elif mode == "serve":
        gates["verdicts"] = (line.get("lost") == 0 and line.get("wrong") == 0
                             and line.get("fallback_items") == 0)
    elif mode == "serve-fleet":
        bars = line.get("bars", {})
        gates["ok"] = bool(bars.get("gated_counts_ok")
                           and bars.get("merge_exact_everywhere"))
    elif mode == "latency":
        gates["converged"] = all(r["converged"]
                                 for r in line.get("latency", {}).values())
        gates["ok"] = all(r["ok"] for r in line.get("latency", {}).values())
    elif mode == "soak":
        gates["health"] = line.get("vs_baseline") == 1.0
        gates["converged"] = line.get("converged") is True
    elif mode == "proofs":
        gates["verified"] = line.get("verified") is True
    elif mode == "sim":
        gates["converged"] = (line.get("converged") == line.get("scenarios")
                              and not line.get("diverged"))
    return gates


def _polled_snapshots(polls):
    """Wrap for FleetRouter.poll_snapshots (see _patched) that appends
    each (router, snapshots) it returns to ``polls``."""
    def wrap(fn):
        def polled(self, *args, **kwargs):
            snaps = fn(self, *args, **kwargs)
            polls.append((self, snaps))
            return snaps
        return polled
    return wrap


def _bench_fleet_workers(torch, line, polls, shapes):
    """serve-fleet's bls workers, from each fleet's last snapshots (the
    sweep polls every worker after its run): the gates that they ran on
    the card, launched the step kernel, and left no ladder or oracle
    record; their own launch counts summed; and every (program, rows)
    they launched kernel 1 at noted in ``shapes``."""
    from consensus_specs_tpu_torch.serve import fleet_smoke

    last = {}
    for router, snaps in polls:
        last[router] = snaps  # a fleet's last poll, fleets in spawn order
    fleets = list(last.values())
    counts = line.get("worker_counts", [])
    rows = [line.get("fleet", {}).get(str(n), {}) for n in counts]
    gates = {"worker_snapshots": len(fleets) == len(counts) and all(
        len(snaps) == n for snaps, n in zip(fleets, counts))}
    try:
        for snaps in fleets:
            fleet_smoke.check_worker_devices(snaps, torch.device("cuda"))
        gates["workers_on_card"] = bool(fleets)
    except AssertionError as e:
        print(f"chip_smoke: bench serve-fleet: {e}", file=sys.stderr)
        gates["workers_on_card"] = False
    gates["workers_launched"] = bool(rows) and all(
        row.get("worker_kernels") and all(
            kernels.get("vm_step", 0) > 0
            for kernels in row["worker_kernels"].values())
        for row in rows)
    ladder = {label: 0 for label in _LADDER}
    fallbacks = 0
    launches = {"vm_step": 0, "vm_step_steps": 0, "mont_mul": 0}
    for snaps in fleets:
        for snap in snaps.values():
            for label in _LADDER:
                ladder[label] += snap["stats"].get(label, {}).get("calls", 0)
            serve = snap["extra"].get("serve", {})
            fallbacks += (serve.get("fallback_items", 0)
                          + serve.get("backend_retries", 0))
            for key in launches:
                launches[key] += snap["extra"]["kernels"].get(key, 0)
    gates["no_worker_ladder_record"] = not any(ladder.values()) \
        and fallbacks == 0
    if all(gates.values()):
        for snaps in fleets:
            _fleet_launch_shapes(snaps, shapes)
    return gates, launches


def phase_bench(torch, card, shapes):
    """The port's bench entry (bench/entry.main) in this process, once a
    mode, on the card, at BENCH_MODES' knobs: each mode's value, unit,
    vs_baseline, gate flags, seconds and kernel launches. Fails on an
    error line, a false gate, a ladder record in a mode without injected
    faults (serve-fleet's workers included: on the card, each launching
    the step kernel), or no launch of either kernel over committee, epoch
    and codec together. The serve-fleet workers' launch shapes join
    ``shapes`` (this process's are recorded by the caller)."""
    import io
    import tempfile

    from consensus_specs_tpu_torch.bench import entry
    from consensus_specs_tpu_torch.serve.fleet import FleetRouter

    modes, launches = {}, {"vm_step": 0, "vm_step_steps": 0, "mont_mul": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, knobs in BENCH_MODES:
            knobs = dict(knobs)
            if mode == "soak":
                knobs["CONSENSUS_SPECS_TPU_SOAK_DIR"] = os.path.join(
                    tmp, "soak")
            buf, polls = io.StringIO(), []
            with _env(knobs), contextlib.redirect_stdout(buf), _patched(
                    FleetRouter, "poll_snapshots", _polled_snapshots(polls)):
                rc = entry.main(["--mode", mode])
            lines = buf.getvalue().strip().splitlines()
            _check(len(lines) == 1, f"bench {mode}: {len(lines)} lines")
            line = json.loads(lines[0])
            _check(rc == 0 and "error" not in line,
                   f"bench {mode}: rc {rc}, {line.get('error')}")
            gates = _bench_gates(mode, line)
            if mode != "serve":  # serve's stream injects a backend fault
                ladder = _ladder_records()
                gates["no_ladder_record"] = not any(ladder.values())
            worker_launches = None
            if mode == "serve-fleet":
                worker_gates, worker_launches = _bench_fleet_workers(
                    torch, line, polls, shapes)
                gates.update(worker_gates)
            _check(all(gates.values()), f"bench {mode}: gates {gates}")
            _check(line["platform"] == "gpu"
                   and line["device"]["name"] == card["card"],
                   f"bench {mode}: ran on {line['platform']} {line['device']}")
            modes[mode] = {
                "value": line["value"], "unit": line["unit"],
                "vs_baseline": line["vs_baseline"], "gates": gates,
                "seconds": line["seconds"], "launches": line["launches"],
                "knobs": knobs}
            for k in launches:
                launches[k] += line["launches"][k]
            if worker_launches is not None:
                # each worker process counts from 0: the path's launches
                # hold them as phase fleet's do
                modes[mode]["worker_launches"] = worker_launches
                for k in launches:
                    launches[k] += worker_launches[k]
            _emit({"phase": "bench", "mode": mode, **modes[mode],
                   "line": line, **card})
    core = [modes[m]["launches"] for m in ("committee", "epoch", "codec")]
    _check(sum(c["vm_step"] for c in core) > 0
           and sum(c["mont_mul"] for c in core) > 0,
           f"bench: committee, epoch and codec launched {core}")
    return {"phase": "bench", "modes": modes,
            "seconds": sum(m["seconds"] for m in modes.values()),
            **card}, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import consensus_specs_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script "
              f"({e})", file=sys.stderr)
        return 2
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: imported {port.__file__}, not this checkout's "
              "package", file=sys.stderr)
        return 2
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_build, cuda_step

    dev = torch.device("cuda")
    name, power = (s.strip() for s in _nvidia_smi("name,power.limit").split(","))
    card = {"card": name, "power_limit": power}
    props = torch.cuda.get_device_properties(0)
    sm_clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    imad_rate = props.multi_processor_count * IMAD_PER_SM_CLOCK \
        * sm_clock_mhz * 1e6
    l2_ns = L2_HIT_CYCLES / sm_clock_mhz * 1e3
    rng = np.random.default_rng(SEED)

    try:
        t0 = time.perf_counter()
        reports = cuda_build.build()
        build_s = time.perf_counter() - t0
        _emit({"phase": "build", "kernels": list(cuda_build.KERNELS),
               "compiled": sorted(reports), "build_s": build_s,
               "ptxas": {k: _ptxas_summary(log) for k, log in reports.items()},
               "vm_step_block_threads": cuda_step.block_threads(
                   bls_backend.W_MUL, bls_backend.W_LIN, 1, 1),
               "sms": props.multi_processor_count,
               "sm_clock_max_mhz": sm_clock_mhz, **card})

        k_mont = phase_mont_mul(torch, dev, rng, imad_rate)
        k_step = phase_vm_step(torch, dev, rng, imad_rate)
        _emit({"phase": "kernels", "results": [k_mont, k_step],
               "elapsed_s": time.perf_counter() - t0, **card})

        _emit({**phase_program(torch, dev, rng),
               "elapsed_s": time.perf_counter() - t0, **card})

        slice_line, launches, slice_run = phase_slice(torch, card)
        _emit({**slice_line, "elapsed_s": time.perf_counter() - t0})

        # after the slice, whose cold call assembles the same programs
        streams = phase_streams(torch, dev, rng, imad_rate, l2_ns)
        _emit({"phase": "kernels", "results": streams, "l2_hit_ns": l2_ns,
               "elapsed_s": time.perf_counter() - t0, **card})

        rlc_line, rlc_head, rlc_mont, rlc_runs = phase_rlc(
            torch, dev, rng, imad_rate, card, slice_run,
            slice_line["warm_best_of_3"]["wall_s"])
        _emit({**rlc_line, "elapsed_s": time.perf_counter() - t0})
        streams.append(rlc_head)
        _emit({"phase": "kernels", "results": [rlc_head] + rlc_mont,
               "elapsed_s": time.perf_counter() - t0, **card})

        codec_line, codec_streams, codec_mont, codec_runs = phase_codec(
            torch, dev, rng, imad_rate, l2_ns, card)
        _emit({**codec_line, "elapsed_s": time.perf_counter() - t0})
        streams += codec_streams
        _emit({"phase": "kernels", "results": codec_streams + codec_mont,
               "elapsed_s": time.perf_counter() - t0, **card})

        serve_line, serve_launches, serve_input = phase_serve(torch, card)
        _emit({**serve_line, "elapsed_s": time.perf_counter() - t0})

        # the later phases' keys and signatures, built in spawned processes;
        # the programs and row counts each phase launches kernel 1 at are
        # noted, then held against the plain steps below
        from consensus_specs_tpu_torch.ops import vm
        from consensus_specs_tpu_torch.utils.keygen import KeyPool

        path_launches, path_shapes = {}, {}
        with KeyPool() as pool:
            for path, phase in (("wide", phase_wide), ("epoch", phase_epoch),
                                ("mainnet", phase_mainnet),
                                ("spec", phase_spec), ("kzg", phase_kzg),
                                ("forks", phase_forks)):
                shapes = path_shapes[path] = {}
                program_wrap, execute_wrap = _recording_launch_shapes(shapes)
                with _patched(bls_backend, "_program", program_wrap), \
                        _patched(vm, "execute", execute_wrap):
                    line, path_launches[path] = phase(torch, pool, card)
                if "_fleet_slot" in line:
                    mainnet_slot = line.pop("_fleet_slot")
                _emit({**line, "elapsed_s": time.perf_counter() - t0})

            # the serve fleet: worker processes on the card; their launch
            # shapes come home in their snapshots
            line, path_launches["fleet"], path_shapes["fleet"] = phase_fleet(
                torch, card, serve_input, serve_line["main"], mainnet_slot)
            _emit({**line, "elapsed_s": time.perf_counter() - t0})

            # the light-client proof plane: its own launch shapes, and
            # those of the proof smoke's workers (from their snapshots)
            shapes = path_shapes["lightclient"] = {}
            program_wrap, execute_wrap = _recording_launch_shapes(shapes)
            with _patched(bls_backend, "_program", program_wrap), \
                    _patched(vm, "execute", execute_wrap):
                line, path_launches["lightclient"], smoke_shapes = \
                    phase_lightclient(torch, pool, card)
            for key, shape in smoke_shapes.items():
                shapes.setdefault(key, shape)
            _emit({**line, "elapsed_s": time.perf_counter() - t0})

        # the simnet: crypto-free, no kernel launched by design
        line, path_launches["sim"] = phase_sim(torch, card)
        _emit({**line, "elapsed_s": time.perf_counter() - t0})

        # the spec tests' @always_bls cases, signatures on the card
        shapes = path_shapes["spec_tests"] = {}
        program_wrap, execute_wrap = _recording_launch_shapes(shapes)
        with _patched(bls_backend, "_program", program_wrap), \
                _patched(vm, "execute", execute_wrap):
            line, path_launches["spec_tests"] = phase_spec_tests(torch, card)
        line["new_shapes"] = new_launch_shapes(path_shapes, "spec_tests",
                                               streams)
        _emit({**line, "elapsed_s": time.perf_counter() - t0})

        # the test-vector generators, the bls generator's checks on the card
        shapes = path_shapes["gen"] = {}
        program_wrap, execute_wrap = _recording_launch_shapes(shapes)
        with _patched(bls_backend, "_program", program_wrap), \
                _patched(vm, "execute", execute_wrap):
            line, path_launches["gen"] = phase_gen(torch, card)
        line["new_shapes"] = new_launch_shapes(path_shapes, "gen", streams)
        _emit({**line, "elapsed_s": time.perf_counter() - t0})

        # the bench entry's modes; what they launch joins the last line
        shapes = path_shapes["bench"] = {}
        program_wrap, execute_wrap = _recording_launch_shapes(shapes)
        with _patched(bls_backend, "_program", program_wrap), \
                _patched(vm, "execute", execute_wrap):
            line, path_launches["bench"] = phase_bench(torch, card, shapes)
        _emit({**line, "elapsed_s": time.perf_counter() - t0})

        path_streams = phase_path_streams(torch, dev, rng, imad_rate, l2_ns,
                                          path_shapes, streams)
        streams += path_streams
        _emit({"phase": "kernels", "paths": list(path_shapes),
               "shapes_launched": {p: len(s) for p, s in path_shapes.items()},
               "results": path_streams, "l2_hit_ns": l2_ns,
               "elapsed_s": time.perf_counter() - t0, **card})
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # each path's launches, counted from 0 just before it ran: the per-item
    # slice (cold), the RLC slot (warm best of 3), the tower combine, the
    # fresh slot with the codec prep through each entry point, the serve
    # plane's main stream, and (summed over their runs) the wide buckets,
    # the epoch's flush routes, the mainnet-scale plane, the spec worlds,
    # the KZG batch and the fork worlds, the serve
    # fleet (the sum of its workers' own counts: each worker process
    # counts from 0), the light-client plane (its process and its proof
    # smoke's workers), the simnet, the spec tests' @always_bls
    # cases, the bls generator's checks and the bench entry's modes (this
    # process's counts; the fleet modes' workers count their own)
    paths = {"slice": {"vm_step": launches["vm_step"],
                       "vm_step_steps": launches["vm_step_steps"],
                       "mont_mul": launches["mont_mul"]},
             "serve": serve_launches, **path_launches}
    for path, run in {**rlc_runs, **codec_runs}.items():
        paths[path] = {"vm_step": run["step_kernel_launches"],
                       "vm_step_steps": run["step_kernel_steps"],
                       "mont_mul": run["mont_mul_kernel_launches"]}
    total = {k: sum(p[k] for p in paths.values()) for k in paths["slice"]}
    # kzg needs the step kernel only: its items are oracle points (no
    # decode, no subgroup check, no hash to G2), so the Montgomery kernel
    # has no work on that path
    # the simnet launches none: its verdicts ride in the signature bytes
    idle = [f"{path} {k}" for path in ("wide", "epoch", "mainnet", "spec",
                                       "kzg", "forks", "fleet", "lightclient",
                                       "spec_tests", "gen", "bench")
            for k in ("vm_step", "mont_mul") if paths[path][k] == 0
            and (path, k) != ("kzg", "mont_mul")]
    if idle:
        print(f"chip_smoke: FAILED: kernels never launched on {idle}",
              file=sys.stderr)
        return 1
    # vm_step's line: the checked heads of every real stream
    head_bytes = sum(r["head_bytes"] for r in streams)
    head_imad = sum(r["head_imad"] for r in streams)
    step_bound = _bound(head_bytes, head_imad, imad_rate)
    # mont_mul's line: the tower combine's 144-product shape
    mont = rlc_mont[0]

    kernels = [
        {"name": "vm_step", "route": "cuda",
         "source": "consensus_specs_tpu_torch/csrc/vm_step.cu",
         "replaces": "consensus_specs_tpu/ops/pallas_step.py:53",
         "launches": total["vm_step"], "steps": total["vm_step_steps"],
         "launches_by_path": {k: p["vm_step"] for k, p in paths.items()},
         "work": f"first {CHECK_STEPS} steps of "
                 + " and ".join(f"{r['stream']} ({r['rows']} rows)"
                                for r in streams),
         "max_abs_err": max([k_step["max_abs_err"]]
                            + [r["max_abs_err"] for r in streams]),
         "ms": sum(r["head_ms"] for r in streams),
         "plain_ms": sum(r["head_plain_ms"] for r in streams),
         "bound_ms": step_bound["bound_ms"],
         "bound_by": step_bound["bound_by"], "library_ms": None},
        {"name": "mont_mul", "route": "cuda",
         "source": "consensus_specs_tpu_torch/csrc/mont_mul.cu",
         "replaces": "consensus_specs_tpu/ops/pallas_fq.py:129",
         "launches": total["mont_mul"],
         "launches_by_path": {k: p["mont_mul"] for k, p in paths.items()},
         "work": f"{mont['products']} products {mont['shape']}",
         "max_abs_err": max([k_mont["max_abs_err"]]
                            + [r["max_abs_err"] for r in rlc_mont]),
         "ms": mont["ms"], "plain_ms": mont["plain_ms"],
         "bound_ms": mont["bound_ms"], "bound_by": mont["bound_by"],
         "library_ms": None},
    ]
    print(f"{name}, {power}", flush=True)
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
