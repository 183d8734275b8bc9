"""The port's mesh-sharded verify plane on CPU meshes (the mirror of
tests/test_mesh_rlc.py's tier-1 cases): ``vm.execute(mesh=)`` limb for
limb equal to the unsharded call on the interpreter and on the fused
route (1-D and (2, 2) meshes, each slot's ledger lane, the divisibility
and device contracts); ``batch_verify_rlc`` over a 4-slot mesh on the
mixed batch, with the verdicts and RLC_STATS deltas of the unsharded call
and of the JAX package's ``batch_verify_rlc(mesh=)`` on 4 virtual CPU
devices under the same injected rng, and the combine's chunk products
reduced by the butterfly; and the per-item path's filler rows."""
import random

import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu.ops import bls_backend as jbb
from consensus_specs_tpu.utils import jax_env
from consensus_specs_tpu_torch.obs import devices
from consensus_specs_tpu_torch.ops import bls_backend as bb
from consensus_specs_tpu_torch.ops import cuda_step, fq, mesh_rlc, profiling
from consensus_specs_tpu_torch.ops import vm, vm_compile
from consensus_specs_tpu_torch.utils import bls
from consensus_specs_tpu_torch.utils import bls12_381 as O
from consensus_specs_tpu_torch.utils import torch_env
from consensus_specs_tpu_torch.utils.bls12_381 import R

one_thread()

CPU = torch.device("cpu")


def _program():
    prog = vm.Prog()
    a, b, c = (prog.inp(n) for n in "abc")
    k = prog.const(12345)
    acc = (a * b + k) - c
    for _ in range(4):
        acc = acc * acc + (b - a)
    prog.out(acc, "r")
    return prog.assemble(w_mul=64, w_lin=64, pad_steps_to=256,
                         pad_regs_to=64)


def _inputs(rows, seed=17):
    rng = random.Random(seed)
    ints = [{n: rng.randrange(O.P) for n in "abc"} for _ in range(rows)]
    ins = {n: np.stack([fq.to_mont_int(row[n]) for row in ints])
           for n in "abc"}
    want = []
    for row in ints:
        a, b, c = row["a"], row["b"], row["c"]
        acc = (a * b + 12345 - c) % O.P
        for _ in range(4):
            acc = (acc * acc + b - a) % O.P
        want.append(acc)
    return ins, want


@pytest.mark.parametrize("route", ["interp", "fused"])
def test_sharded_execute_equals_unsharded_limb_for_limb(route, monkeypatch):
    """The rows split into contiguous blocks in slot order; every route's
    outputs equal the unsharded call's limbs and the exact ints, on a
    4-slot 1-D mesh and a (2, 2) one; each call is labelled sharded=True
    and noted on every slot's lane."""
    assembled = _program()
    ins, want = _inputs(8)
    vm_compile.reset_fused_state()
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "3")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", route)
    devices.reset_global()
    profiling.reset()
    launches = cuda_step.LAUNCHES
    try:
        base = vm.execute(assembled, ins, batch_shape=(8,), device=CPU)
        for mesh in (torch_env.make_mesh(4, CPU),
                     torch_env.make_mesh(4, CPU, ("host", "chip"), (2, 2))):
            got = vm.execute(assembled, ins, batch_shape=(8,), mesh=mesh)
            assert np.array_equal(got["r"], base["r"])
            assert got["r"].dtype == np.uint64
        assert [fq.from_mont_limbs(x) for x in base["r"]] == want
        assert vm_compile._COUNTERS["fallbacks"] == 0
        if route == "fused":
            assert vm_compile._COUNTERS["executions"] == 3
    finally:
        vm_compile.reset_fused_state()
    assert cuda_step.LAUNCHES == launches  # the plain steps on the CPU
    stats, _ = profiling.stats_and_gauges()
    assert any("sharded=True" in k for k in stats)
    assert any("sharded=False" in k for k in stats)
    lanes = devices.global_ledger().snapshot()["lanes"]
    assert {"cpu", "cpu.0", "cpu.1", "cpu.2", "cpu.3"} <= set(lanes)
    assert lanes["cpu.3"]["events"] == 2


def test_sharded_execute_contracts():
    """batch_shape[0] must divide by the slot count; a device that is not
    one of the mesh's raises."""
    assembled = _program()
    ins, _ = _inputs(6)
    mesh = torch_env.make_mesh(4, CPU)
    with pytest.raises(ValueError, match="does not shard"):
        vm.execute(assembled, ins, batch_shape=(6,), mesh=mesh)
    with pytest.raises(ValueError, match="not a device"):
        vm.execute(assembled, {n: v[:4] for n, v in ins.items()},
                   batch_shape=(4,), device="cuda:1", mesh=mesh)


def test_auto_serves_fused_only_at_a_built_mesh_signature(monkeypatch):
    """``auto`` takes the fused route under a mesh only once every slot's
    units are built (a pinned fused call builds them); the background
    warm never queues a sharded signature."""
    assembled = _program()
    ins, _ = _inputs(4)
    mesh = torch_env.make_mesh(2, CPU)
    vm_compile.reset_fused_state()
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_WARM_BG", "1")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK", "4")
    try:
        sig = vm_compile.mesh_shape_sig(4, mesh)
        assert sig == ("mesh", (2, None), (2, None))
        assembled._exec_stats = {"fused_ms_row": 1.0, "interp_ms_row": 5.0}
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
        assert not vm_compile.use_fused(assembled, shape_sig=sig)
        assert not vm_compile._BG_PENDING
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "fused")
        vm.execute(assembled, ins, batch_shape=(4,), mesh=mesh)
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
        assembled._exec_stats = {"fused_ms_row": 1.0, "interp_ms_row": 5.0}
        assert vm_compile.use_fused(assembled, shape_sig=sig)
    finally:
        vm_compile.reset_fused_state()


def _committee(tag: int, k: int = 2, good: bool = True):
    sks = [1000 * tag + j + 1 for j in range(k)]
    pks = [bls.SkToPk(sk) for sk in sks]
    msg = (b"msh%03d" % tag) + b"\x00" * 26
    sig = bls.Sign(sum(sks) % R, msg)
    if not good:
        msg = b"\xff" + msg[1:]
    return ("fast_aggregate", pks, msg, sig)


def _mixed_items():
    """Every input class: valid, corrupted message, undecodable
    signature, infinity signature, infinity pubkey."""
    return [
        _committee(1, k=2, good=True),
        _committee(2, k=1, good=False),
        ("fast_aggregate", [bls.SkToPk(7)], b"m" * 32,
         b"\xa0" + b"\x01" * 95),
        ("fast_aggregate", [bls.SkToPk(8)], b"n" * 32,
         b"\xc0" + b"\x00" * 95),
        ("fast_aggregate", [b"\xc0" + b"\x00" * 47],
         b"p" * 32, bls.Sign(9, b"p" * 32)),
    ]


def test_mesh_verdicts_and_rlc_trajectory_equal_unsharded(monkeypatch):
    """batch_verify_rlc over a 4-slot mesh: the verdicts and RLC_STATS
    deltas of the unsharded call and of the JAX package's call on a
    4-device mesh, with the same injected rng; the corrupted item bisects
    through the failed sharded combine, whose chunk products (chunk 1 a
    slot) the butterfly reduces."""
    bls.use_py_ecc()
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_CHUNK", "2")
    reduced = []
    real = mesh_rlc.mesh_fq12_product

    def spy(products, mesh):
        reduced.append((products.shape[0], mesh.size))
        return real(products, mesh)

    monkeypatch.setattr(mesh_rlc, "mesh_fq12_product", spy)
    items = _mixed_items()
    before = dict(bb.RLC_STATS)
    single = bb.batch_verify_rlc(items, device=CPU, rng=random.Random(0xA5))
    mid = dict(bb.RLC_STATS)
    got = bb.batch_verify_rlc(items, mesh=torch_env.make_mesh(4, CPU),
                              rng=random.Random(0xA5))
    after = dict(bb.RLC_STATS)
    j_before = dict(jbb.RLC_STATS)
    j_got = jbb.batch_verify_rlc(items, mesh=jax_env.get_mesh("4"),
                                 rng=random.Random(0xA5))
    d_jax = {k: jbb.RLC_STATS[k] - j_before[k] for k in j_before}
    d_single = {k: mid[k] - before[k] for k in before}
    d_mesh = {k: after[k] - mid[k] for k in before}
    assert list(got) == list(single) == list(j_got) == \
        [True, False, False, False, False]
    assert d_mesh == d_single
    assert {k: d_mesh[k] for k in d_jax} == d_jax
    assert d_mesh["items"] == 2 and d_mesh["bisections"] >= 1
    assert d_mesh["final_exps"] == 3
    assert reduced == [(2, 4)]


def test_mesh_filler_rows_never_flip_verdicts():
    """The per-item path with rows padded to the slot count: 3 items on 4
    slots run one filler row, whose generator-point lanes never leak into
    real verdicts."""
    bls.use_py_ecc()
    items = [_committee(200, k=1), _committee(201, k=1, good=False),
             _committee(202, k=1)]
    args = ([it[1] for it in items], [it[2] for it in items],
            [it[3] for it in items])
    sharded = bb.batch_fast_aggregate_verify(
        *args, mesh=torch_env.make_mesh(4, CPU))
    unsharded = bb.batch_fast_aggregate_verify(*args, device=CPU)
    assert np.array_equal(sharded, unsharded)
    assert list(sharded) == [True, False, True]
