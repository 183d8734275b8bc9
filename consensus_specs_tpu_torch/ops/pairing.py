"""Pairing-side Fq12 routines over ops/towers.py: ``rlc_combine`` only,
the counterpart of consensus_specs_tpu/ops/pairing.py's, limb for limb.
The Miller loop and the final exponentiation are not ported (the device
path runs them as VM programs)."""
import torch

from . import towers


def rlc_combine(fs: torch.Tensor, rs_bits: torch.Tensor) -> torch.Tensor:
    """Random-linear-combination combine: prod_i f_i^{r_i} as ONE Fq12.

    fs: (N, 12, 15) flat Fq12 batch (loose Montgomery limbs); rs_bits:
    (N, B) exponent bits, msb-first, on fs' device. Returns (12, 15). Each
    item runs the square-and-multiply ladder with its bits as RUNTIME
    values (a select per item per bit, one Python step per bit column in
    place of the JAX package's ``lax.scan``); the powered values then
    tree-reduce pairwise into one element. Every Fq12 product is one
    batched ``fq.mont_mul``: the CUDA kernel on the card."""
    n = fs.shape[0]
    ident = towers.fq12_one((n,), fs.device)
    acc = ident
    for bit_col in rs_bits.to(torch.bool).T:
        acc = towers.fq12_square(acc)
        acc = towers.fq12_mul(acc, towers.fq12_select(bit_col, fs, ident))
    # log-depth pairwise tree reduce of the N powered values
    while acc.shape[0] > 1:
        m = acc.shape[0] // 2
        head = towers.fq12_mul(acc[: 2 * m : 2], acc[1 : 2 * m : 2])
        acc = head if acc.shape[0] % 2 == 0 else torch.cat(
            [head, acc[-1:]], dim=0)
    return acc[0]
