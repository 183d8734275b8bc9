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


@pytest.mark.parametrize("m", [1, 255, 257, 4099])
def test_mont_mul_kernel_matches_plain(dev, m):
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    rng = np.random.default_rng(m)
    a = torch.from_numpy(_loose(rng, (m,))).to(dev)
    b = torch.from_numpy(_loose(rng, (m,))).to(dev)
    before = cuda_fq.LAUNCHES
    got = cuda_fq.mont_mul(a, b)
    assert cuda_fq.LAUNCHES == before + 1
    assert torch.equal(got, fq.mont_mul_plain(a, b))


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
    instr = tuple(
        torch.from_numpy(np.ascontiguousarray(
            x[None].astype(np.uint8 if x.dtype == bool else np.int32))).to(dev)
        for x in instr)
    before = cuda_step.LAUNCHES
    got = cuda_step.run_steps(regs.clone(), instr)
    assert cuda_step.LAUNCHES == before + 1
    want = vm._vm_step_plain(regs.clone(), tuple(x[0] for x in instr))
    assert torch.equal(got, want)


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
