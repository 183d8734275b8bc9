"""The port stands alone: it imports neither jax nor any module of the JAX
package (nor does chip_smoke.py), and its entry points never quietly fall
back to the CPU."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, sys
import consensus_specs_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    __import__(m)
from consensus_specs_tpu_torch.ops import codec, fq
a = fq.limbs_from_numpy(fq.ONE_MONT, "cpu")
out = fq.mont_mul_plain(a, a)
hashed = codec.message_limbs_batch([b"abc"], b"DST", device="cpu")
# the serve plane, its observability and the switchboard, driven once
from consensus_specs_tpu_torch.obs import registry
from consensus_specs_tpu_torch.serve import VerificationService
from consensus_specs_tpu_torch.utils import bls
class Backend:
    def batch_fast_aggregate_verify(self, pks, msgs, sigs, device=None):
        return [s.endswith(b"ok") for s in sigs]
class Oracle:
    def verify_one(self, p):
        return False
with VerificationService(backend=Backend(), oracle=Oracle(), device="cpu",
                         max_wait_ms=1) as svc:
    served = svc.submit("fast_aggregate", [b"k"], b"m", b"ok").result(30)
# the port's own spec, with the chain plane on top
from consensus_specs_tpu_torch import builder
from consensus_specs_tpu_torch.chain import HeadService
spec = builder.build_spec_module("phase0", "minimal")
state = spec.BeaconState(validators=[spec.Validator(
    effective_balance=spec.MAX_EFFECTIVE_BALANCE,
    exit_epoch=spec.FAR_FUTURE_EPOCH, withdrawable_epoch=spec.FAR_FUTURE_EPOCH)
    for _ in range(8)], balances=[spec.MAX_EFFECTIVE_BALANCE] * 8)
anchor = spec.BeaconBlock(state_root=spec.hash_tree_root(state))
head = HeadService(spec, state, anchor, differential=True)
# the draft-era forks over the port's own KZG plane
sharding = builder.build_spec_module("sharding", "minimal")
custody = builder.build_spec_module("custody_game", "mainnet")
from consensus_specs_tpu_torch.utils import kzg
# the light-client proof plane and the simnet on the port's own spec
from consensus_specs_tpu_torch import sim
from consensus_specs_tpu_torch.lightclient import build_head_proof, verify_head_proof
proof = build_head_proof(spec, state)
verify_head_proof(spec, proof, bytes(state.hash_tree_root()))
sim_run = sim.run_scenario(sim.get_scenario("partition_heal"), seed=7,
                           device="cpu")
# the generators, their YAML writer, the debug codecs and the deposit
# model, driven once: a tree written without PyYAML
import io, contextlib, tempfile
from consensus_specs_tpu_torch.gen import digests, yaml_writer
from consensus_specs_tpu_torch.gen.generators import ssz_generic
from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.deposit_contract import DepositContractModel
with tempfile.TemporaryDirectory() as tmp, \
        contextlib.redirect_stdout(io.StringIO()):
    gen_rc = ssz_generic.main(["-o", tmp])
    gen_digest = digests.tree_digest(tmp)
deposits = DepositContractModel()
deposits.deposit(bytes(32))
import chip_smoke
print(json.dumps({
    "gen": [gen_rc, gen_digest == digests.PINNED["ssz_generic"],
            yaml_writer.dump(encode(spec.Checkpoint(epoch=3)))],
    "deposit_root": len(deposits.get_deposit_root()),
    "spec": spec.__name__,
    "spec_bls": spec.bls.__name__,
    "draft_specs": [sharding.__name__, custody.__name__],
    "kzg_setup": sharding.KZG_SETUP is kzg.lazy_setup(
        int(sharding.KZG_SETUP_TAU), int(sharding.KZG_SETUP_SIZE)),
    "g1_setup_1": bytes(custody.G1_SETUP[1]).hex(),
    "head": bytes(head.get_head()) == bytes(spec.hash_tree_root(anchor)),
    "proof_branch": len(proof.finality_branch),
    "sim": [sim_run.converged, sim_run.digest],
    "modules": mods,
    "one_squared": fq.from_mont_limbs(out.numpy()),
    "hashed": len(hashed),
    "served": served,
    "switchboard": bls.backend_name(),
    "prometheus": "serve_submit_to_result" in registry.render_prometheus(),
    "native_sha256": sorted(m for m in sys.modules if "native_sha256" in m),
    "yaml": "yaml" in sys.modules,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules
                        if m == "consensus_specs_tpu"
                        or m.startswith("consensus_specs_tpu.")),
}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # one line: importing bench/__main__ (and every module) ran no bench
    assert len(res.stdout.strip().splitlines()) == 1, res.stdout[:2000]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert "consensus_specs_tpu_torch.ops.bls_backend" in got["modules"]
    assert "consensus_specs_tpu_torch.ops.cuda_step" in got["modules"]
    assert "consensus_specs_tpu_torch.ops.codec" in got["modules"]
    for mod in ("serve.service", "serve.load", "serve.metrics", "serve.cache",
                "obs.tracing", "obs.flight", "obs.devices", "obs.latency",
                "obs.registry", "obs.hist", "obs.programs", "obs.fsio",
                "ops.profiling", "utils.bls", "utils.keygen", "batch_verify",
                "scale.registry", "scale.pubkeys", "scale.hierarchy",
                "scale.smoke", "bench.epoch_replay", "serve.worker",
                "serve.fleet", "serve.fleet_smoke", "scale.routing",
                "obs.snapshot", "obs.fleet", "obs.slo", "obs.timeseries",
                "obs.exposition", "builder", "config.config_util",
                "utils.ssz.ssz_typing", "utils.ssz.ssz_impl",
                "utils.ssz.gindex", "utils.hash_function",
                "utils.native_sha256", "merkle.levels", "merkle.cache",
                "merkle.plane", "chain.head_service", "chain.proto_array",
                "chain.metrics", "chain.health", "test.context",
                "test.helpers.genesis", "test.helpers.attestations",
                "test.helpers.sync_committee", "utils.kzg", "utils.das",
                "utils.sharding", "utils.custody", "ops.kzg_backend",
                "test.helpers.execution_payload", "test.helpers.shard_blob",
                "test.helpers.custody_game", "test.helpers.fork_transition",
                "utils.ssz.proofs", "lightclient.proof_tree",
                "lightclient.serve_proofs", "lightclient.proof_smoke",
                "bench.proofs", "sim.fabric", "sim.scenarios",
                "sim.adversary", "sim.node", "sim.runner", "sim.smoke",
                "sim.fleet_replay", "sim.latency_smoke",
                "bench.sim_matrix", "bench.entry", "bench.__main__",
                "bench.head_replay", "bench.codec_prep", "bench.rlc_final",
                "bench.mainnet", "bench.latency_pipeline",
                "bench.fleet_sweep", "bench.soak", "bench.merkle",
                "sim.soak_smoke", "merkle.smoke", "utils.snappy",
                "gen.gen_typing", "gen.gen_runner", "gen.gen_from_tests",
                "gen.yaml_writer", "gen.digests", "debug.encode",
                "debug.decode", "debug.random_value",
                "deposit_contract.model") + tuple(
                    "gen.generators." + g for g in (
                        "bls", "epoch_processing", "finality", "fork_choice",
                        "forks", "genesis", "merkle", "operations", "random",
                        "rewards", "sanity", "shuffling", "ssz_generic",
                        "ssz_static", "transition")):
        assert "consensus_specs_tpu_torch." + mod in got["modules"], mod
    assert got["one_squared"] == 1
    assert got["hashed"] == 1
    assert got["served"] is True and got["prometheus"] is True
    # the switchboard defaults to the card (resolved on first verify)
    assert got["switchboard"] == "gpu"
    assert got["spec"] == "consensus_specs_tpu_torch.phase0.minimal"
    assert got["spec_bls"] == "consensus_specs_tpu_torch.utils.bls"
    assert got["head"] is True
    assert got["proof_branch"] == 6
    # the simnet's determinism pin: the JAX package's digest at seed 7
    assert got["sim"] == [True, "32cd72ad34dcfbce"]
    assert got["draft_specs"] == ["consensus_specs_tpu_torch.sharding.minimal",
                                  "consensus_specs_tpu_torch.custody_game.mainnet"]
    assert got["kzg_setup"] is True and len(got["g1_setup_1"]) == 96
    assert got["jax"] == []
    assert got["reference"] == []
    # the port's own hashing binding only; built specs need no PyYAML, nor
    # do the generators: the ssz_generic tree equals the JAX generator's
    assert got["native_sha256"] == ["consensus_specs_tpu_torch.utils.native_sha256"]
    assert got["gen"] == [0, True, "{epoch: 3, root: '0x" + "00" * 32 + "'}\n"]
    assert got["deposit_root"] == 32
    assert got["yaml"] is False


def test_fleet_worker_process_imports_no_jax_and_no_reference_module():
    """The workers are processes of their own: a port verdict worker,
    spawned by the port's router, reports (through its snapshot) every
    module it loaded. None is jax or of the JAX package, it never loaded
    the CUDA build or initialized CUDA, and it runs on the router's
    device."""
    from consensus_specs_tpu_torch.serve.fleet import FleetRouter

    router = FleetRouter(
        workers=1, backend="verdict", device="cpu",
        env={"CONSENSUS_SPECS_TPU_FLEET_REPORT_MODULES": "1",
             "SERVE_MAX_WAIT_MS": "1"})
    try:
        assert router.submit("fast_aggregate", [b"\x01" * 48], b"m" * 32,
                             b"\x02" * 96).result(timeout=30) is True
        extra = router.poll_snapshots()["w0"]["extra"]
    finally:
        router.close()
    mods = extra["modules"]
    assert "consensus_specs_tpu_torch.serve.load" in mods
    assert "consensus_specs_tpu_torch.serve.service" in mods
    assert [m for m in mods if m == "jax" or m.startswith("jax.")] == []
    assert [m for m in mods if m == "consensus_specs_tpu"
            or m.startswith("consensus_specs_tpu.")] == []
    assert "consensus_specs_tpu_torch.ops.cuda_build" not in mods
    assert extra["cuda_initialized"] is False
    assert extra["device"] == "cpu"


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of chip_smoke.py, at any depth, names the
    port, torch or the standard library: never jax or the JAX package."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "consensus_specs_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "consensus_specs_tpu"}, roots


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_gpu(no_gpu):
    from consensus_specs_tpu_torch.ops import bls_backend, vm

    pk, msg, sig = b"\x00" * 48, b"\x00" * 32, b"\x00" * 96
    calls = [
        lambda: bls_backend.verify(pk, msg, sig),
        lambda: bls_backend.fast_aggregate_verify([pk], msg, sig),
        lambda: bls_backend.aggregate_verify([pk], [msg], sig),
        lambda: bls_backend.batch_fast_aggregate_verify([[pk]], [msg], [sig]),
        lambda: bls_backend.batch_aggregate_verify([[pk]], [[msg]], [sig]),
        lambda: vm.execute(_tiny_program(), {"a": np.zeros((1, 15), np.uint64)},
                           batch_shape=(1,)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _tiny_program():
    from consensus_specs_tpu_torch.ops import vm

    p = vm.Prog()
    a = p.inp("a")
    p.out(a * a, "y")
    return p.assemble(w_mul=1, w_lin=1)


def test_explicit_cpu_device_still_runs(no_gpu):
    from consensus_specs_tpu_torch.ops import fq, vm

    one = fq.to_mont_int(3)[None]
    out = vm.execute(_tiny_program(), {"a": one}, batch_shape=(1,),
                     device="cpu")
    assert fq.from_mont_limbs(out["y"][0]) == 9


def test_kernel_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card is refused, never run
    through the plain version."""
    from consensus_specs_tpu_torch.ops import cuda_fq, cuda_step

    meta = torch.zeros((2, 15), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        cuda_fq.mont_mul(meta, meta)
    regs = torch.zeros((1, 4, 15), dtype=torch.int64, device="meta")
    instr = tuple(torch.zeros((1, 1), dtype=torch.int32, device="meta")
                  for _ in range(7))
    with pytest.raises(ValueError):
        cuda_step.run_steps(regs, instr)


def test_serve_plane_raises_without_a_gpu(no_gpu):
    """The service and the serve bench resolve ``device=None`` to the card
    and refuse to start without one."""
    from consensus_specs_tpu_torch.serve import VerificationService, load

    with pytest.raises(RuntimeError, match="no CUDA device"):
        VerificationService(backend=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load.run_serve_bench()
