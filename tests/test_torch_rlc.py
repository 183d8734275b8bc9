"""The port's RLC verification plane (consensus_specs_tpu_torch/ops/
bls_backend.py: batch_verify_rlc, the combine backends, the final
exponentiation routes and the final-exp batcher) against the JAX
package's, on the CPU.

Both sides get the same items and the same injected ``random.Random``, so
they draw the same scalars and must return the same verdicts with the
same RLC_STATS deltas. Combines run in chunks of 2
(CONSENSUS_SPECS_TPU_RLC_CHUNK) so the programs stay small; the JAX side
runs its VM in the interpreter with the jnp Montgomery product, as
tests/test_torch_bls.py runs it.
"""
import random
import threading
import time

import numpy as np

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

import pytest  # noqa: E402
import torch  # noqa: E402

from consensus_specs_tpu.ops import bls_backend as jbls  # noqa: E402
from consensus_specs_tpu.ops import vm as jvm  # noqa: E402
from consensus_specs_tpu.utils import bls  # noqa: E402
from consensus_specs_tpu.utils.bls12_381 import P, R  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend as tbls  # noqa: E402
from consensus_specs_tpu_torch.ops import fq, vm  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reference_modes(monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_CHUNK", "2")
    for var in ("CONSENSUS_SPECS_TPU_HARD_PART", "CONSENSUS_SPECS_TPU_RLC_FINAL",
                "CONSENSUS_SPECS_TPU_RLC_BACKEND",
                "CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS"):
        monkeypatch.delenv(var, raising=False)


def _committee(tag: int, k: int = 2, good: bool = True):
    """One fast_aggregate item; the message corrupted after signing when
    not ``good`` (tests/test_rlc.py's generator)."""
    sks = [1000 * tag + j + 1 for j in range(k)]
    pks = [bls.SkToPk(sk) for sk in sks]
    msg = (b"rlc%03d" % tag) + b"\x00" * 26
    sig = bls.Sign(sum(sks) % R, msg)
    if not good:
        msg = b"\xff" + msg[1:]
    return ("fast_aggregate", pks, msg, sig)


def _aggregate_item(tag: int, k: int = 2):
    sks = [5000 * tag + j + 1 for j in range(k)]
    pks = [bls.SkToPk(sk) for sk in sks]
    msgs = [(b"ag%03d_%d" % (tag, j)) + b"\x00" * 24 for j in range(k)]
    sig = bls.Aggregate([bls.Sign(sk, m) for sk, m in zip(sks, msgs)])
    return ("aggregate", pks, msgs, sig)


def _mixed():
    good_sig = bls.Sign(9, b"p" * 32)
    return [
        _committee(1, k=2, good=True),
        _committee(2, k=1, good=False),                 # wrong message
        ("fast_aggregate", [bls.SkToPk(7)], b"m" * 32,
         b"\xa0" + b"\x01" * 95),                       # undecodable sig
        ("fast_aggregate", [bls.SkToPk(8)], b"n" * 32,
         b"\xc0" + b"\x00" * 95),                       # infinity sig
        ("fast_aggregate", [b"\xc0" + b"\x00" * 47],
         b"p" * 32, good_sig),                          # infinity pubkey
    ]


# the tier-1 cases of tests/test_rlc.py: (items, rng seed, verdicts,
# required RLC_STATS deltas)
CASES = {
    "mixed": (_mixed, 0xA5, [True, False, False, False, False],
              {"items": 2, "combines": 1, "bisections": 1}),
    "all_valid": (lambda: [_committee(11), _committee(12), _committee(13)],
                  1, [True, True, True],
                  {"combines": 1, "bisections": 0, "final_exps": 1}),
    "all_invalid": (lambda: [_committee(21, good=False),
                             _committee(22, good=False)], 2, [False, False],
                    {"bisections": 1}),
    "batch_of_one": (lambda: [_committee(31)], 4, [True], {"combines": 0}),
    "mixed_kinds": (lambda: [_committee(41), _aggregate_item(42)], 3,
                    [True, True], {"combines": 1, "final_exps": 1}),
}


def _deltas(stats, before):
    return {k: stats[k] - before[k] for k in stats}


def _capture(monkeypatch, module, name, sink):
    """Wrap module.name so each call's numpy-converted result lands in
    ``sink``."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.append({n: np.asarray(v) for n, v in out.items()}
                    if isinstance(out, dict) else out)
        return out
    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_verify_rlc_matches_reference(case, monkeypatch):
    """Verdicts and RLC_STATS deltas equal the JAX package's. Every
    program's raw outputs (PROG A, the rlc_combine program, the hard
    parts) and every combined element are captured on both sides and
    must be equal: for all_valid that is the 3-candidate combine in two
    chunks of 2, folded into one program row and multiplied on the
    host."""
    make, seed, verdicts, required = CASES[case]
    items = make()
    seen = {"jax": ([], []), "port": ([], [])}
    for side, vm_mod, bls_mod in (("jax", jvm, jbls), ("port", vm, tbls)):
        _capture(monkeypatch, vm_mod, "execute", seen[side][0])
        _capture(monkeypatch, bls_mod, "_rlc_combine_vm", seen[side][1])
    before = dict(jbls.RLC_STATS)
    want = jbls.batch_verify_rlc(items, rng=random.Random(seed))
    want_d = _deltas(jbls.RLC_STATS, before)
    before = dict(tbls.RLC_STATS)
    got = tbls.batch_verify_rlc(items, device="cpu", rng=random.Random(seed))
    got_d = _deltas(tbls.RLC_STATS, before)
    assert got.dtype == bool
    assert list(got) == list(want) == verdicts
    assert got_d == want_d
    assert {k: got_d[k] for k in required} == required
    (t_outs, t_combined), (j_outs, j_combined) = seen["port"], seen["jax"]
    assert t_combined == j_combined
    assert len(t_combined) == required.get("combines", len(t_combined))
    assert len(t_outs) == len(j_outs)
    for got_out, want_out in zip(t_outs, j_outs):
        assert sorted(got_out) == sorted(want_out)
        for name, v in got_out.items():
            assert np.array_equal(v, want_out[name]), name
    if case == "all_valid":
        assert sum(".c." in n for n in t_outs[1]) == 24  # 2 chunks x 12


def test_batch_verify_rlc_empty_and_bad_kind():
    assert list(tbls.batch_verify_rlc([], device="cpu")) == []
    with pytest.raises(ValueError):
        tbls.batch_verify_rlc([("proposer", [b"x"], b"m", b"s")],
                              device="cpu")
    with pytest.raises(ValueError):
        jbls.batch_verify_rlc([("proposer", [b"x"], b"m", b"s")])


def test_rlc_scalars_match_reference():
    for seed in (7, 8):
        got = tbls._rlc_scalars(8, random.Random(seed))
        assert np.array_equal(got, jbls._rlc_scalars(8, random.Random(seed)))
        assert got.dtype == np.uint8 and got.shape == (8, 128)
        assert (got.sum(axis=1) > 0).all()
    d = tbls._rlc_scalars(3)  # os.urandom
    assert d.shape == (3, 128) and (d.sum(axis=1) > 0).all()


def test_final_exp_is_one_host_and_device_agree(monkeypatch):
    rng = random.Random(21)
    good = [1] + [0] * 11
    bad = [rng.randrange(P) for _ in range(12)]
    for mode in ("host", "device"):
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_FINAL", mode)
        for f, want in ((good, True), (bad, False)):
            before = dict(tbls.RLC_STATS)
            assert tbls._final_exp_is_one(list(f), CPU) is want
            assert jbls._final_exp_is_one(list(f)) is want
            d = _deltas(tbls.RLC_STATS, before)
            assert d["final_exps"] == 1
            assert d["final_exp_windows"] == (mode == "device")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_FINAL", "host")
    assert tbls._final_exp_is_one([0] * 12, CPU) is False  # degenerate f


def test_rlc_final_mode_routing(monkeypatch):
    assert tbls._rlc_final_mode(CPU) == "host"
    assert tbls._rlc_final_mode(torch.device("cuda")) == "device"
    for mode in ("host", "device"):
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_FINAL", mode)
        assert tbls._rlc_final_mode(CPU) == tbls._rlc_final_mode("cuda") == mode
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_BACKEND", "jax")
    assert tbls._rlc_backend() == jbls._rlc_backend() == "jax"
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_BACKEND", "other")
    assert tbls._rlc_backend() == jbls._rlc_backend() == "vm"
    for m in (1, 2, 3, 5, 64):
        assert tbls._rlc_chunk(m) == jbls._rlc_chunk(m)
    monkeypatch.delenv("CONSENSUS_SPECS_TPU_RLC_CHUNK")
    for m in (2, 17, 63, 64):
        assert tbls._rlc_chunk(m) == jbls._rlc_chunk(m)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_HARD_PART", "windowed")
    assert tbls._hard_part_kind(1) == jbls._hard_part_kind(1) \
        == "hard_part_windowed"


def test_hard_part_oracle_matches_program_on_real_item():
    """The host hard part and the port's hard_part_frobenius program on
    the easy-part output of a real Miller value: the same res, 1 for the
    valid item; the easy part of a perturbed f (unitary, as every
    program input is) gives the same res != 1 on both."""
    _, pks, msg, sig = _committee(71, k=1)
    out, lay, precheck = tbls._miller_fast_aggregate([pks], [msg], [sig], CPU)
    assert out is not None and precheck[0]
    r, ns = lay.split(0)
    f_row = np.stack([out[f"{ns}f.{j}"][r] for j in range(12)])
    f = [fq.from_mont_limbs(c) for c in f_row]
    g = tbls._easy_part_flat(f)
    g_bad = tbls._easy_part_flat([(f[0] + 1) % P] + f[1:])
    prog, _ = tbls._program("hard_part_frobenius", 0, 1)
    for coeffs, ok in ((g, True), (g_bad, False)):
        ins = {f"g.{j}": fq.to_mont_int(c)[None] for j, c in enumerate(coeffs)}
        res = vm.execute(prog, ins, batch_shape=(1,), device="cpu")
        res = [fq.from_mont_limbs(res[f"res.{j}"][0]) for j in range(12)]
        want = tbls._oracle_to_flat_ints(
            tbls.hard_part_res_oracle(tbls._flat_ints_to_oracle(coeffs)))
        assert res == want == jbls._oracle_to_flat_ints(
            jbls.hard_part_res_oracle(jbls._flat_ints_to_oracle(coeffs)))
        assert (res == [1] + [0] * 11) is ok
        assert tbls._hard_part_is_one_oracle(coeffs) is ok


# -- the final-exp batcher (tests/test_bls_backend_fast.py's cases) ----------


def _threads(target, args_list):
    threads = [threading.Thread(target=target, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def test_final_exp_batcher_coalesces_concurrent_rows(monkeypatch):
    calls = []

    def fake_run(rows, device, kind=None):
        calls.append((rows.shape[0], kind))
        time.sleep(0.01)
        return np.ones(rows.shape[0], dtype=bool)

    monkeypatch.setattr(tbls, "_run_hard_part", fake_run)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS", "80")
    batcher = tbls._FinalExpBatcher()
    results = []
    barrier = threading.Barrier(4)
    before = dict(tbls.RLC_STATS)

    def worker():
        barrier.wait()
        g = np.zeros((12, fq.NUM_LIMBS), dtype=np.uint64)
        results.append(batcher.run(g, CPU))

    _threads(worker, [()] * 4)
    assert results == [True] * 4
    assert calls == [(4, "hard_part_frobenius")]  # one coalesced window
    d = _deltas(tbls.RLC_STATS, before)
    assert (d["final_exp_windows"], d["final_exp_window_rows"]) == (1, 4)


def test_final_exp_batcher_keys_windows_by_device(monkeypatch):
    """Rows bound for different devices never share an execution."""
    calls = []

    def fake_run(rows, device, kind=None):
        calls.append((rows.shape[0], device))
        return np.ones(rows.shape[0], dtype=bool)

    monkeypatch.setattr(tbls, "_run_hard_part", fake_run)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS", "80")
    batcher = tbls._FinalExpBatcher()
    barrier = threading.Barrier(4)
    results = []

    def worker(device):
        barrier.wait()
        g = np.zeros((12, fq.NUM_LIMBS), dtype=np.uint64)
        results.append(batcher.run(g, device))

    cuda = torch.device("cuda")  # a key only: the fake run touches nothing
    _threads(worker, [(CPU,), (cuda,), (CPU,), (cuda,)])
    assert results == [True] * 4
    assert sorted((n, str(d)) for n, d in calls) == [(2, "cpu"), (2, "cuda")]


def test_final_exp_batcher_propagates_failures(monkeypatch):
    """A failed window fails every joined caller (never hangs a
    follower), and a later window recovers."""
    def boom(rows, device, kind=None):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(tbls, "_run_hard_part", boom)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS", "50")
    batcher = tbls._FinalExpBatcher()
    errs = []
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait()
        g = np.zeros((12, fq.NUM_LIMBS), dtype=np.uint64)
        try:
            batcher.run(g, CPU)
            errs.append(None)
        except RuntimeError as e:
            errs.append(str(e))

    _threads(worker, [()] * 2)
    assert errs == ["device fell over"] * 2
    monkeypatch.setattr(
        tbls, "_run_hard_part",
        lambda rows, device, kind=None: np.ones(rows.shape[0], dtype=bool))
    g = np.zeros((12, fq.NUM_LIMBS), dtype=np.uint64)
    assert batcher.run(g, CPU) is True


def test_reset_rlc_stats():
    tbls.RLC_STATS["combines"] += 3
    tbls.reset_rlc_stats()
    assert all(v == 0 for v in tbls.RLC_STATS.values())
    assert sorted(tbls.RLC_STATS) == sorted(jbls.RLC_STATS)
