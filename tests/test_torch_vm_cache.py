"""The port's program cache (consensus_specs_tpu_torch/ops/bls_backend.py,
``.vm_cache_torch/``) on the CPU: the mirror of
tests/test_bls_backend_fast.py's per-program key and prune cases.

Each registry kind has its own fingerprint from (vm + fq, the shared vmlib
source, its own claimed builder source), the kinds claimed as in the JAX
package; editing one builder re-keys that kind alone;
CONSENSUS_SPECS_TPU_VM_CACHE moves the directory; a hit touches its entry,
a pickle without schedule metadata is assembled anew; prune evicts by
staleness, idle age and size.
"""
import dataclasses
import os
import pickle
import time

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.ops import vmlib as jvmlib  # noqa: E402
from consensus_specs_tpu_torch.ops import (  # noqa: E402
    bls_backend, profiling, vmlib,
)
from tests.torch_threads import one_thread  # noqa: E402

one_thread()


def test_program_fingerprints_are_per_kind():
    fps = {k: bls_backend._program_fingerprint(k) for k in vmlib.BUILDERS}
    assert len(set(fps.values())) == len(fps)
    assert fps["hard_part"] == bls_backend._program_fingerprint("hard_part")


def test_builder_claims_equal_the_jax_package():
    """Each kind claims the same functions as in the JAX package, and the
    split cuts them out of the shared source."""
    claims = {k: [f.__name__ for f in fns]
              for k, fns in vmlib.BUILDER_LOCAL_FNS.items()}
    assert claims == {k: [f.__name__ for f in fns]
                      for k, fns in jvmlib.BUILDER_LOCAL_FNS.items()}
    shared, local_hp = vmlib.builder_source_parts("hard_part")
    _, local_frob = vmlib.builder_source_parts("hard_part_frobenius")
    assert "def _emit_hard_part(" not in shared
    assert "def _emit_hard_part_frobenius(" not in shared
    assert "def _emit_hard_part(" in local_hp
    assert "def _emit_hard_part_frobenius(" in local_frob
    assert "def _emit_hard_part_frobenius(" not in local_hp
    assert "def f12_mul(" in shared
    assert "def f12_cyclotomic_square_comps(" in shared


def test_editing_one_builder_rekeys_only_that_kind(monkeypatch):
    kinds = ("hard_part", "hard_part_frobenius", "rlc_combine")
    before = {k: bls_backend._program_fingerprint(k) for k in kinds}
    real = vmlib.builder_source_parts

    def perturbed(kind):
        shared, local = real(kind)
        if kind == "hard_part_frobenius":
            local = local + "# edited\n"
        return shared, local

    monkeypatch.setattr(vmlib, "builder_source_parts", perturbed)
    bls_backend._program_fingerprint.cache_clear()
    bls_backend._core_fingerprint_parts.cache_clear()
    try:
        after = {k: bls_backend._program_fingerprint(k) for k in kinds}
    finally:
        monkeypatch.undo()
        bls_backend._program_fingerprint.cache_clear()
        bls_backend._core_fingerprint_parts.cache_clear()
    assert after["hard_part_frobenius"] != before["hard_part_frobenius"]
    assert after["hard_part"] == before["hard_part"]
    assert after["rlc_combine"] == before["rlc_combine"]


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    default = bls_backend._vm_cache_dir()
    assert default.endswith(".vm_cache_torch")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_CACHE", str(tmp_path / "c"))
    assert bls_backend._vm_cache_dir() == str(tmp_path / "c")
    assert os.path.isdir(tmp_path / "c")


def test_program_cache_hits_touch_and_refuse_pre_meta_pickles(monkeypatch,
                                                              tmp_path):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_CACHE", str(tmp_path))
    bls_backend._program.cache_clear()
    try:
        prog, fold = bls_backend._program("g2_subgroup", 0, 1)
        assert fold == 1 and prog.meta["trash_mul"] > 0
        (path,) = [p for p in tmp_path.iterdir() if p.name.startswith("v")]
        assert path.name == (
            f"v{bls_backend._VM_CACHE_VERSION}_"
            f"{bls_backend._program_fingerprint('g2_subgroup')}_g2_subgroup"
            "_k0_f1_w96x192_p256.pkl")
        old = time.time() - 5 * 86400
        os.utime(path, (old, old))
        bls_backend._program.cache_clear()
        again, _ = bls_backend._program("g2_subgroup", 0, 1)
        assert os.stat(path).st_mtime > old + 86400  # the hit touched it
        # a pickle without schedule metadata never loads: assembled anew
        stale = dataclasses.replace(again, meta=None)
        with open(path, "wb") as fh:
            pickle.dump(stale, fh)
        bls_backend._program.cache_clear()
        fresh, _ = bls_backend._program("g2_subgroup", 0, 1)
        assert fresh.meta and fresh.meta["fused_key"][0] == "g2_subgroup"
    finally:
        bls_backend._program.cache_clear()


def test_prune_vm_cache_evicts_by_idle_age_and_size(tmp_path):
    d = str(tmp_path)
    now = time.time()
    for name, age_days, size in (
        ("v1_aaaa_old1.pkl", 40, 1000),
        ("v1_aaaa_old2.pkl", 41, 1000),
        ("v1_bbbb_new1.pkl", 1, 1000),
        ("v1_bbbb_new2.pkl", 0, 1000),
    ):
        p = os.path.join(d, name)
        with open(p, "wb") as fh:
            fh.write(b"\x00" * size)
        os.utime(p, (now - age_days * 86400, now - age_days * 86400))
    with open(os.path.join(d, "README.txt"), "w") as fh:
        fh.write("not a cache entry")

    out = bls_backend.prune_vm_cache(max_age_days=30, max_bytes=0,
                                     cache_dir=d)
    assert out["evicted"] == 2 and out["kept"] == 2
    assert sorted(os.listdir(d)) == ["README.txt", "v1_bbbb_new1.pkl",
                                     "v1_bbbb_new2.pkl"]
    summ = profiling.summary()
    assert summ["bls.vm_cache_pruned_entries"] == {"gauge": 2.0}
    assert summ["bls.vm_cache_pruned_bytes"] == {"gauge": 2000.0}

    out = bls_backend.prune_vm_cache(max_age_days=0, max_bytes=1000,
                                     cache_dir=d)
    assert out["evicted"] == 1 and out["kept"] == 1
    assert out["kept_bytes"] == 1000
    assert sorted(os.listdir(d)) == ["README.txt", "v1_bbbb_new2.pkl"]
    out = bls_backend.prune_vm_cache(max_age_days=0, max_bytes=0,
                                     cache_dir=d)
    assert out["evicted"] == 0 and out["kept"] == 1


def test_prune_evicts_stale_fingerprint_entries(tmp_path):
    d = str(tmp_path)
    cur_fp = bls_backend._program_fingerprint("hard_part")
    v = bls_backend._VM_CACHE_VERSION
    names = {
        f"v{v}_{cur_fp}_hard_part_k0_f1_w96x192_p256.pkl": False,
        f"v{v}_{'0' * 10}_hard_part_k0_f32_w96x192_p256.pkl": True,
        f"v{v - 1}_{'a' * 10}_hard_part_k0_f1_w96x192_p256.pkl": True,
        f"v{v}_{'b' * 10}_future_kind_k0_f1_w96x192_p256.pkl": False,
        "v1_aaaa_old1.pkl": False,
        # a crash-orphaned write of a current entry: evicted by age only
        f"v{v}_{cur_fp}_hard_part_k0_f2_w96x192_p256.pkl.123.tmp": False,
    }
    for name in names:
        with open(os.path.join(d, name), "wb") as fh:
            fh.write(b"\x00" * 10)
    out = bls_backend.prune_vm_cache(max_age_days=0, max_bytes=0,
                                     cache_dir=d)
    assert out["evicted"] == 2
    left = set(os.listdir(d))
    for name, evicted in names.items():
        assert (name not in left) == evicted, name
    out = bls_backend.prune_vm_cache(max_age_days=0, max_bytes=0,
                                     cache_dir=d, evict_stale=False)
    assert out["evicted"] == 0


def test_prune_tool_prints_one_json_line(tmp_path):
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / f"v{bls_backend._VM_CACHE_VERSION - 1}_aa_g2_subgroup"
                "_k0_f1_w96x192_p256.pkl").write_bytes(b"x")
    res = subprocess.run(
        [sys.executable, os.path.join(repo, "tools",
                                      "torch_vm_cache_prune.py")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CONSENSUS_SPECS_TPU_VM_CACHE=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == {"kept": 0, "evicted": 1,
                                      "kept_bytes": 0, "evicted_bytes": 1}
