"""The port's hard-part canary (consensus_specs_tpu_torch/ops/
finalexp_smoke.py) on the CPU: the windowed and frobenius variants
bit-identical to the exact-int oracle over the whole input matrix; a
broken oracle caught and its flight journal dumped; no card without
``device="cpu"``; and the caller's flight-recorder variables restored
every time."""
import pytest
import torch

from consensus_specs_tpu_torch.ops import bls_backend, finalexp_smoke
from tests.torch_threads import one_thread

one_thread()

ENV = ("CONSENSUS_SPECS_TPU_FLIGHT", "CONSENSUS_SPECS_TPU_FLIGHT_DUMP")


@pytest.fixture
def env(monkeypatch, tmp_path):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_CACHE", str(tmp_path / "vm"))
    monkeypatch.delenv("CONSENSUS_SPECS_TPU_FLIGHT", raising=False)
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                       str(tmp_path / "flight.jsonl"))
    return tmp_path


def _restored(tmp_path):
    import os

    return (os.environ.get(ENV[0]) is None
            and os.environ[ENV[1]] == str(tmp_path / "flight.jsonl"))


def test_smoke_passes_on_the_cpu(env, capsys):
    assert finalexp_smoke.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "windowed: 6 unitary + 2 adversarial cases checked on cpu" in out
    assert "frobenius: 6 unitary + 2 adversarial cases checked on cpu" in out
    assert "OK: windowed + frobenius bit-identical" in out
    assert _restored(env)
    assert not (env / "flight.jsonl").exists()


def test_a_wrong_oracle_fails_the_smoke_and_dumps_the_journal(
        env, capsys, monkeypatch):
    monkeypatch.setattr(bls_backend, "hard_part_res_oracle", lambda g: g)
    # the windowed variant alone (the canary holds every routed variant
    # but bit_serial)
    monkeypatch.setattr(bls_backend, "_HARD_PART_KINDS", {
        k: v for k, v in bls_backend._HARD_PART_KINDS.items()
        if k != "frobenius"})
    assert finalexp_smoke.main(device="cpu") == 1
    out = capsys.readouterr().out
    assert "windowed/random-unitary-1: VM res != exact-int HHT" in out
    assert "frobenius" not in out
    assert "flight journal dumped to" in out
    assert (env / "flight.jsonl").exists()
    assert _restored(env)


def test_without_a_card_the_smoke_exits_non_zero(env, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert finalexp_smoke.main() == 2
    assert "no CUDA device" in capsys.readouterr().out
    assert _restored(env)
