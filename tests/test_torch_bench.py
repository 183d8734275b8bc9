"""The port's bench layer (consensus_specs_tpu_torch/bench/) against the JAX
package's (consensus_specs_tpu/bench/), on the CPU.

Each port mode runs through the entry, ``bench.entry.main(["--mode", m,
"--device", "cpu"])``, which prints one line with ``bench.py``'s keys;
the JAX module runs in this process on its CPU platform, at the same
knobs (env vars) and seeds. Every deterministic field is held equal
across the two, never a time: the head replay's per-tree counts, the
epoch's check triples and shape, the codec's outputs limb for limb, the
RLC bench's shape and ``RLC_STATS``, the per-item finalization's
verdicts, and the merkle cells' roots. The planes' benches (mainnet,
latency, soak) are in tests/test_torch_bench_planes.py.
"""
import contextlib
import io
import json
import os

import numpy as np
from tests.torch_threads import one_thread

one_thread()

KEYS = ("metric", "value", "unit", "vs_baseline", "mode", "platform",
        "device", "launches", "seconds")
_LINES = {}


@contextlib.contextmanager
def _env(knobs):
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


def _port_line(mode, knobs):
    """The entry's one line for ``mode`` on the CPU (cached a mode)."""
    if mode not in _LINES:
        from consensus_specs_tpu_torch.bench import entry

        buf = io.StringIO()
        with _env(knobs), contextlib.redirect_stdout(buf):
            rc = entry.main(["--mode", mode, "--device", "cpu"])
        lines = buf.getvalue().strip().splitlines()
        assert len(lines) == 1, lines
        line = json.loads(lines[0])
        assert rc == 0 and "error" not in line, line
        for key in KEYS:
            assert key in line, key
        assert line["mode"] == mode and line["platform"] == "cpu"
        assert line["device"] is None
        _LINES[mode] = line
    return _LINES[mode]


@contextlib.contextmanager
def _digests(module, name="run_scenario"):
    """Record the digest of every scenario ``module``'s bench runs."""
    real = getattr(module, name)
    seen = []

    def recorded(*args, **kwargs):
        report = real(*args, **kwargs)
        seen.append((report.digest, bool(report.converged)))
        return report
    setattr(module, name, recorded)
    try:
        yield seen
    finally:
        setattr(module, name, real)


HEAD = {"HEAD_TREE_SIZES": "16,32", "HEAD_EPOCHS": "2",
        "HEAD_EVENTS_PER_EPOCH": "16", "HEAD_SPEC_QUERIES": "2"}


def test_head_replay_equal():
    from consensus_specs_tpu.bench.head_replay import run_head_bench

    got = _port_line("head", HEAD)
    with _env(HEAD):
        want = run_head_bench()
    keys = ("blocks", "applied", "deferred", "resolved", "dropped",
            "head_changes", "reorgs", "proto_queries", "spec_queries",
            "heads_match")
    assert len(got["trees"]) == len(want["trees"]) == 2
    for g, w in zip(got["trees"], want["trees"]):
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
        assert g["heads_match"] is True
    for k in ("blocks", "epochs", "events_per_epoch", "batch", "seed",
              "unit", "metric"):
        assert got[k] == want[k], k
    assert got["launches"]["vm_step"] == got["launches"]["mont_mul"] == 0


EPOCH = {"BENCH_EPOCH_SLOTS": "1", "BENCH_EPOCH_COMMITTEES": "2",
         "BENCH_EPOCH_K": "4", "BENCH_EPOCH_K_SYNC": "4", "BENCH_REPS": "0"}


def test_epoch_replay_equal(tmp_path, monkeypatch):
    """The same check triples in record order, every verdict True on the
    port's card path (its bench asserts it) and on the JAX package's
    exact-int oracle, and the JAX bench's shape fields."""
    from consensus_specs_tpu.bench import epoch_replay as jep
    from consensus_specs_tpu.utils import bls as jbls
    from consensus_specs_tpu_torch.bench import epoch_replay as tep

    monkeypatch.setattr(jep, "_cache_path", lambda *a: str(
        tmp_path / ("epoch_%dx%dx%ds%dp%d.pkl" % a)))
    jcol = jep.build_epoch_checks(1, 2, 4, 4, 4)
    triples = tep.epoch_triples(1, 2, 4, 4, 4)
    assert [(list(map(bytes, c.pubkeys)), bytes(c.messages),
             bytes(c.signature)) for c in jcol.checks] == [
        (list(map(bytes, p)), bytes(m), bytes(s)) for p, m, s in triples]
    monkeypatch.setattr(jbls, "bls_active", True)
    monkeypatch.setattr(jbls, "_backend", "py_ecc")
    assert all(jbls.FastAggregateVerify(c.pubkeys, c.messages, c.signature)
               for c in jcol.checks)
    got = _port_line("epoch", EPOCH)
    # the JAX bench's fields for this shape: 1 x (2 x 4 + 4 + 1) signatures
    want = {"mode": "epoch", "slots": 1, "committees": 2, "k": 4,
            "signatures": 13, "rlc": True}
    for k, v in want.items():
        assert got[k] == v, k
    assert got["checks"] == len(triples) == 4
    assert got["launches"] == {"vm_step": 0, "vm_step_steps": 0,
                               "mont_mul": 0, "pow_chain": 0}


def test_codec_outputs_equal():
    """The port's batched codec outputs equal the per-item oracle's (its
    bench's gate) and the JAX package's batched outputs, limb for limb."""
    from consensus_specs_tpu.bench import codec_prep as jcp
    from consensus_specs_tpu.ops import bls_backend as jbb
    from consensus_specs_tpu.ops import codec as jcodec
    from consensus_specs_tpu_torch.bench import codec_prep as tcp
    from consensus_specs_tpu_torch.ops import bls_backend as tbb
    from consensus_specs_tpu_torch.ops import codec as tcodec

    got = _port_line("codec", {"CODEC_ITEMS": "4"})
    assert got["outputs_match"] is True and got["items_per_kind"] == 4
    assert got["device_path"] is False  # the raw-int path on the CPU
    pks, sigs, msgs = tcp._build_inputs(4, 7)
    assert (pks, sigs, msgs) == jcp._build_inputs(4, 7)
    pairs = (
        (tcodec.pubkey_limbs_batch(pks, device="cpu"),
         jcodec.pubkey_limbs_batch(pks)),
        (tcodec.signature_limbs_batch(sigs, device="cpu"),
         jcodec.signature_limbs_batch(sigs)),
        (tcodec.message_limbs_batch(msgs, tbb.DST, device="cpu"),
         jcodec.message_limbs_batch(msgs, jbb.DST)),
    )
    for port_out, jax_out in pairs:
        assert len(port_out) == len(jax_out) == 4
        for a, b in zip(port_out, jax_out):
            assert tcp._same(a, tuple(np.asarray(x) for x in b)
                             if isinstance(b, tuple) else np.asarray(b))


def test_rlc_bench_equal():
    """The same sizes table's shape, final route and RLC_STATS: each N's
    per-item and RLC warm-up and timed runs, 0 combines counted outside
    batch_verify_rlc, 0 bisections."""
    from consensus_specs_tpu.bench.rlc_final import run_rlc_bench
    from consensus_specs_tpu.ops import bls_backend as jbb

    got = _port_line("rlc", {"RLC_BENCH_NS": "2"})
    jbb.reset_rlc_stats()
    with _env({"RLC_BENCH_NS": "2"}):
        want = run_rlc_bench()
    for k in ("mode", "n", "gate_n", "chunk", "final", "reps"):
        assert got[k] == want[k], k
    assert set(got["sizes"]) == set(want["sizes"]) == {"2"}
    assert got["rlc_stats"] == dict(jbb.RLC_STATS)
    assert got["rlc_stats"]["bisections"] == 0
    assert got["launches"]["vm_step"] == 0  # the plain steps on the CPU


def test_finalize_per_item_equal():
    """(N, 12, L) f rows through both packages' per-item finalization: 1
    (True), a planted non-one row (False) and 0 (degenerate: False)."""
    from consensus_specs_tpu.ops import bls_backend as jbb
    from consensus_specs_tpu_torch.ops import bls_backend as tbb
    from consensus_specs_tpu_torch.ops import fq

    rng = np.random.default_rng(11)
    fs = np.zeros((3, 12, fq.NUM_LIMBS), dtype=np.uint64)
    fs[0, 0] = fq.to_mont_int(1)
    for j in range(12):
        fs[1, j] = fq.to_mont_int(
            int.from_bytes(rng.bytes(47), "little") % fq.P)
    got = tbb._finalize_per_item(fs, "cpu")
    want = np.asarray(jbb._finalize_per_item(fs))
    assert got.tolist() == want.tolist() == [True, False, False]


MERKLE = {"CONSENSUS_SPECS_TPU_MERKLE_VALIDATORS": "256",
          "CONSENSUS_SPECS_TPU_MERKLE_BLOCKS": "2"}


def _jax_merkle_roots(n, n_blocks):
    """The three cells' roots, from the JAX package's own objects."""
    from consensus_specs_tpu.builder import build_spec_module
    from consensus_specs_tpu.lightclient.proof_tree import (
        ProofWorld, build_update_artifact)
    from consensus_specs_tpu.scale.registry import attesters_per_slot

    spec = build_spec_module("altair", "minimal")
    world = ProofWorld(spec, validators=n)
    state = world.head_state(world.finalized_slot + 1)
    cold = bytes(state.hash_tree_root())
    n_touch = attesters_per_slot(n)
    for b in range(n_blocks):
        for k in range(n_touch):
            i = (b * n_touch + k) % len(state.validators)
            state.validators[i].effective_balance = spec.Gwei(
                31 * 10**9 + b * n_touch + k)
        state.validators.append(spec.Validator(
            pubkey=spec.BLSPubkey((10**6 + b).to_bytes(48, "little")),
            effective_balance=spec.Gwei(32 * 10**9)))
        state.slot = spec.Slot(int(state.slot) + 1)
    inc = bytes(state.hash_tree_root())
    art = build_update_artifact(
        spec, world.head_state(world.finalized_slot + 100),
        world.finalized_state,
        genesis_validators_root=world.genesis_validators_root,
        sign=world.sign)
    return {"state_cold": cold.hex(), "state_incremental": inc.hex(),
            "proof_world": bytes(art.state_root).hex()}


def test_merkle_cells_roots_equal():
    from consensus_specs_tpu.bench.merkle import run_merkle_bench

    got = _port_line("merkle", MERKLE)
    with _env(MERKLE):
        want = run_merkle_bench()
    assert got["ok"] is want["ok"] is True
    assert set(got["merkle"]) == set(want["merkle"])
    roots = _jax_merkle_roots(256, 2)
    for name, cell in got["merkle"].items():
        assert cell["ok"] is want["merkle"][name]["ok"] is True, name
        assert cell["root"] == roots[name], name
    for k in ("validators", "merkle_mode", "native_available"):
        assert got[k] == want[k], k


def test_merkle_smokes_pass_on_both(tmp_path, monkeypatch, capsys):
    from consensus_specs_tpu.merkle import smoke as jsmoke
    from consensus_specs_tpu_torch.merkle import smoke as tsmoke

    monkeypatch.chdir(tmp_path)
    assert tsmoke.main() == 0
    port_out = capsys.readouterr().out
    assert jsmoke.main() == 0
    jax_out = capsys.readouterr().out
    assert port_out.split(":")[1].split(",")[0] == \
        jax_out.split(":")[1].split(",")[0]  # the same check count
    assert not os.path.exists(tmp_path / "merkle_flight.jsonl")
