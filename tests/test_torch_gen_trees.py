"""Whole generator trees of the port, byte for byte against the JAX
generators' run into a second directory: all of ``ssz_generic`` and
``bls``, ``shuffling`` and ``merkle`` at minimal, ``ssz_static`` at
minimal on phase0 and altair; each JAX tree's digest pinned in
consensus_specs_tpu_torch/gen/digests.py (chip_smoke.py's phase ``gen``
holds the port's trees on the card's machine against the same constants).
Every YAML part the port writes is also held against ``yaml.safe_dump``.

The ``bls`` runs replace each package's cross-check with a recorder; the
two call lists, (kind, args, expected) in order, must be equal."""
import itertools
import os

import pytest
import torch
import yaml

from consensus_specs_tpu.gen import gen_runner as jax_runner
from consensus_specs_tpu.gen import gen_typing as jax_typing
from consensus_specs_tpu.gen.generators import bls as jax_bls
from consensus_specs_tpu.utils import bls as jax_switch
from consensus_specs_tpu_torch.gen import digests, gen_runner, gen_typing
from consensus_specs_tpu_torch.gen.generators import bls as port_bls
from consensus_specs_tpu_torch.utils import bls as port_switch
from tests.torch_threads import one_thread

one_thread()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture
def yaml_parts(monkeypatch):
    """Every text the port's runner writes as YAML, held against
    ``yaml.safe_dump`` of the same plain value."""
    written = []
    dump = gen_runner.yaml_dump

    def checked(value):
        text = dump(value)
        assert text == yaml.safe_dump(value, default_flow_style=None,
                                      sort_keys=False)
        written.append(text)
        return text

    monkeypatch.setattr(gen_runner, "yaml_dump", checked)
    return written


def _same_trees(port_dir, jax_dir, key=None):
    port, jax = _tree(port_dir), _tree(jax_dir)
    assert sorted(port) == sorted(jax)
    for rel in port:
        assert port[rel] == jax[rel], rel
    if key is not None:
        assert digests.tree_digest(jax_dir) == digests.PINNED[key]
        assert digests.tree_digest(port_dir) == digests.PINNED[key]
    return port


@pytest.mark.parametrize("name,args,key", [
    ("ssz_generic", [], "ssz_generic"),
    ("shuffling", ["-l", "minimal"], "shuffling -l minimal"),
    ("merkle", ["-l", "minimal"], "merkle -l minimal"),
])
def test_generator_tree_equals_jax(tmp_path, yaml_parts, name, args, key):
    import importlib

    port = importlib.import_module(
        f"consensus_specs_tpu_torch.gen.generators.{name}")
    jax = importlib.import_module(f"consensus_specs_tpu.gen.generators.{name}")
    assert port.main(["-o", str(tmp_path / "port")] + args) == 0
    assert jax.main(["-o", str(tmp_path / "jax")] + args) == 0
    tree = _same_trees(tmp_path / "port", tmp_path / "jax", key)
    assert len(yaml_parts) == sum(rel.endswith(".yaml") for rel in tree)


def test_ssz_static_minimal_phase0_altair_tree_equals_jax(tmp_path,
                                                          yaml_parts):
    from consensus_specs_tpu.gen.generators import ssz_static as jax_static
    from consensus_specs_tpu_torch.gen.generators import ssz_static

    def selection(make_cases):
        minimal = itertools.takewhile(lambda c: c.preset_name == "minimal",
                                      make_cases())
        return lambda: (c for c in minimal
                        if c.fork_name in ("phase0", "altair"))

    args = ["-l", "minimal"]
    assert gen_runner.run_generator("ssz_static", [gen_typing.TestProvider(
        prepare=lambda: None, make_cases=selection(ssz_static.make_cases))],
        args=["-o", str(tmp_path / "port")] + args) == 0
    assert jax_runner.run_generator("ssz_static", [jax_typing.TestProvider(
        prepare=lambda: None, make_cases=selection(jax_static.make_cases))],
        args=["-o", str(tmp_path / "jax")] + args) == 0
    tree = _same_trees(tmp_path / "port", tmp_path / "jax",
                       "ssz_static -l minimal (phase0, altair)")
    assert len(yaml_parts) == sum(rel.endswith(".yaml") for rel in tree)
    forks = {rel.split(os.sep)[1] for rel in tree}
    assert forks == {"phase0", "altair"}


def test_bls_tree_and_checks_equal_jax(tmp_path, yaml_parts, monkeypatch):
    jax_calls, port_calls, devices = [], [], []
    monkeypatch.setattr(jax_bls, "_tpu_check", lambda kind, args, expected:
                        jax_calls.append((kind, args, expected)))

    def record(kind, args, expected, device):
        port_calls.append((kind, args, expected))
        devices.append(device)

    monkeypatch.setattr(port_bls, "_card_check", record)
    monkeypatch.setattr(jax_switch, "bls_active", True)
    saved = (port_switch._backend, port_switch.bls_active)
    port_switch.bls_active = False  # the run pins it on, then restores it
    try:
        assert port_bls.main(["-o", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
        assert (port_switch._backend, port_switch.bls_active) \
            == (saved[0], False)
    finally:
        port_switch._backend, port_switch.bls_active = saved
    assert jax_bls.main(["-o", str(tmp_path / "jax")]) == 0
    tree = _same_trees(tmp_path / "port", tmp_path / "jax", "bls")
    assert len(tree) == len(yaml_parts) == 29
    assert port_calls == jax_calls
    assert [kind for kind, _, _ in port_calls] == \
        ["verify"] * 6 + ["fast_aggregate_verify"] * 6 \
        + ["aggregate_verify"] * 3
    assert devices == ["cpu"] * 15


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bls_generator_defaults_to_the_card_and_raises_without_one(
        tmp_path, no_gpu, monkeypatch):
    saved = (port_switch._backend, port_switch.bls_active)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bls.main(["-o", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing was generated
    assert (port_switch._backend, port_switch.bls_active) == saved


def test_bls_check_fault_fails_its_case(tmp_path, monkeypatch):
    """A check that disagrees with the oracle, or raises, fails its case:
    the case keeps INCOMPLETE, the run exits 1, and no oracle verdict
    takes the card's place. Here ``verify`` raises and the aggregate
    checks answer True to every input."""
    from consensus_specs_tpu_torch.ops import bls_backend

    def raises(*args, device=None):
        raise RuntimeError("card fault")

    monkeypatch.setattr(bls_backend, "verify", raises)
    for kind in ("fast_aggregate_verify", "aggregate_verify"):
        monkeypatch.setattr(bls_backend, kind,
                            lambda *args, device=None: True)
    saved = (port_switch._backend, port_switch.bls_active)
    assert port_bls.main(["-o", str(tmp_path)], device="cpu") == 1
    assert (port_switch._backend, port_switch.bls_active) == saved
    failed = sorted(os.path.basename(p)
                    for p in gen_runner.detect_incomplete(tmp_path))
    verify = ["valid", "wrong_pubkey", "wrong_message", "infinity_pubkey",
              "infinity_signature", "garbage_signature"]
    fav = ["missing_signer", "wrong_message", "empty_pubkeys",
           "empty_pubkeys_infinity_sig", "infinity_pubkey_member"]
    assert failed == sorted(
        ["verify_" + n for n in verify]
        + ["fast_aggregate_verify_" + n for n in fav]
        + ["aggregate_verify_swapped_messages",
           "aggregate_verify_length_mismatch"])
    log = (tmp_path / gen_runner.ERROR_LOG).read_text()
    assert log.count("card fault") == 6
    assert log.count("card backend disagrees") == 7


def test_bls_check_on_the_cpu_runs_the_plain_steps(monkeypatch):
    """``device="cpu"``: the check's programs run through ``vm.execute``
    on the CPU (the plain steps), and no kernel is launched."""
    from consensus_specs_tpu_torch.ops import cuda_fq, cuda_step, vm

    devices = []
    execute = vm.execute

    def recorded(program, inputs, batch_shape=(), device=None, mesh=None):
        devices.append(device)
        return execute(program, inputs, batch_shape=batch_shape,
                       device=device, mesh=mesh)

    monkeypatch.setattr(vm, "execute", recorded)
    monkeypatch.setattr(port_switch, "bls_active", True)
    sk, msg = port_bls.PRIVKEYS[0], port_bls.MESSAGES[0]
    pk, sig = port_switch.SkToPk(sk), port_switch.Sign(sk, msg)
    launches = (cuda_step.LAUNCHES, cuda_fq.LAUNCHES)
    port_bls._card_check("verify", (pk, msg, sig), True, "cpu")
    assert devices and {torch.device(d) for d in devices} == {
        torch.device("cpu")}
    assert (cuda_step.LAUNCHES, cuda_fq.LAUNCHES) == launches
