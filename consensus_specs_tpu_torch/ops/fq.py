"""Base-field (Fq) limb constants, host helpers and the plain PyTorch
Montgomery multiply for BLS12-381 — the port's counterpart of
consensus_specs_tpu/ops/fq.py.

Representation (unchanged from the JAX package): an Fq element is (..., 15)
limbs of 28 bits (15 * 28 = 420 bits) in Montgomery form with R = 2^420,
loosely reduced (any representative below ~2^405, limbs < 2^28 after every
carry pass).

Limb tensors are ``torch.int64``: torch's unsigned tensors do not support
add, shift, gather or index_put. int64 is exact here because the overflow
audit of ``mont_mul_plain`` keeps every column below 2^61.

``mont_mul_plain`` is the plain version of the CUDA Montgomery multiply
(csrc/mont.cuh). ``mont_mul`` goes through ops/cuda_fq.py: on a CUDA
tensor it launches the kernel, on a CPU tensor it runs the plain version.
The loose-limb API (``add``, ``add_many``, ``compress``, ``sub``, ``neg``,
``canonical``, ``is_zero``, ``eq``, ``select``, ``pow_fixed``, ``inv``,
``const``) is the JAX package's, limb for limb; every Montgomery product in
it goes through ``mont_mul``.
"""
import functools

import numpy as np
import torch

from ..utils.bls12_381 import P

LIMB_BITS = 28
NUM_LIMBS = 15
MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # 420
R_MONT = 1 << R_BITS


def _int_to_limbs_np(x: int) -> np.ndarray:
    out = np.zeros(NUM_LIMBS, dtype=np.uint64)
    for i in range(NUM_LIMBS):
        out[i] = x & MASK
        x >>= LIMB_BITS
    assert x == 0
    return out


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs)
    x = 0
    for i in reversed(range(limbs.shape[-1])):
        x = (x << LIMB_BITS) | int(limbs[..., i])
    return x


P_LIMBS = _int_to_limbs_np(P)
N0 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)  # -p^-1 mod 2^28
R_MOD_P = R_MONT % P
R_INV = pow(R_MONT, -1, P)
ONE_MONT = _int_to_limbs_np(R_MOD_P)  # 1 in Montgomery form
# MP: the smallest multiple of p above 2^402, the additive shift of the
# borrowless subtract (the VM's LIN unit adds MP + 1 + complement(b))
MP = ((1 << 402) // P + 1) * P
MP_LIMBS = _int_to_limbs_np(MP)


def to_mont_int(x: int) -> np.ndarray:
    """Host: encode an integer < p into Montgomery-form limbs."""
    return _int_to_limbs_np((x * R_MONT) % P)


def from_mont_limbs(limbs) -> int:
    """Host: decode (possibly loose) Montgomery-form limbs to an int < p."""
    x = limbs_to_int(limbs)
    return (x * R_INV) % P


def limbs_from_numpy(u64_array, device) -> torch.Tensor:
    """uint64 limb array (any shape, limbs < 2^28) -> int64 tensor on
    ``device``. Raises on a limb that does not fit the carry invariant."""
    arr = np.asarray(u64_array)
    if arr.size and int(arr.max()) >> LIMB_BITS:
        raise ValueError(f"limbs must be < 2^{LIMB_BITS}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def _carry_limbs(t: torch.Tensor, out_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Propagate carries to limbs < 2^28; the value must fit out_limbs
    limbs (a final carry beyond them is dropped). The carried limbs of a
    value are unique, so carry passes over every limb at once, repeated
    until no limb holds a carry (two or three on the step's data), give
    the limbs of a limb-by-limb ripple in a few torch ops."""
    n = t.shape[-1]
    if n < out_limbs:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (out_limbs - n,))], -1)
    x = t[..., :out_limbs]  # higher limbs only add multiples of 2^(28 out)
    c = x >> LIMB_BITS
    while True:
        x = x & MASK  # a new tensor: the caller's is never written
        if not bool(c.any()):
            return x
        x[..., 1:] += c[..., :-1]
        c = x >> LIMB_BITS


# -p^-1 mod 2^420: the whole-number REDC's multiplier
N_PRIME_LIMBS = _int_to_limbs_np((-pow(P, -1, R_MONT)) % R_MONT)
_I = np.arange(NUM_LIMBS)
_COLUMN = (_I[:, None] + _I[None, :]).reshape(-1)  # limb i * limb j -> i + j
# the low half's columns, the rest dropped into a spare column 15
_LOW_COLUMN = np.where(_COLUMN < NUM_LIMBS, _COLUMN, NUM_LIMBS)


def _columns(a: torch.Tensor, b: torch.Tensor, low: bool = False):
    """Raw product columns of (..., 15) limbs: 30 (the low 15 with
    ``low``), each the sum of its limb products, from one outer product."""
    shape = a.shape[:-1]
    prod = (a[..., :, None] * b[..., None, :]).reshape(
        shape + (NUM_LIMBS * NUM_LIMBS,))
    n = NUM_LIMBS + 1 if low else 2 * NUM_LIMBS
    out = a.new_zeros(shape + (n,)).index_add_(
        -1, _const("low_column" if low else "column", a.device), prod)
    return out[..., :NUM_LIMBS] if low else out


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*2^-420 (mod p) on (..., 15) int64 limbs;
    loose in (limbs < 2^28), loose out (< a*b/R + p). Limb for limb the
    JAX package's ``fq.mont_mul_u64`` (schoolbook columns, 15 reduction
    rounds clearing limbs 0..14 low to high, one carry pass), computed as
    whole numbers in about 60 torch ops: the rounds' multipliers m_i form
    M = T * (-p^-1) mod 2^420 (the unique M < 2^420 with T + M*p = 0 mod
    2^420), and their output is the carried limbs of (T + M*p) / 2^420 mod
    2^420: so is this.

    The carry out of the low half is exact without a ripple: every prefix
    of the columns s_0..s_14 of T + M*p is 0 mod its 2^(28(k+1)), so the
    carry u_12 into column 13 is both = -s_13 mod 2^28 and within 2^6 of
    s_12 >> 28 (the carry into column 12 is < 2^34); u_13 and u_14 follow.

    Overflow audit (int64 columns): a column of T or of M*p sums <= 15
    products of limbs < 2^28 (< 2^60), so every column of T + M*p < 2^61."""
    a, b = torch.broadcast_tensors(a, b)
    p = _const("p", a.device).expand_as(a)
    t = _columns(a, b)
    low = _carry_limbs(t[..., :NUM_LIMBS])  # T mod 2^420
    m = _carry_limbs(_columns(low, _const("n_prime", a.device).expand_as(a),
                              low=True))
    s = t + _columns(m, p)
    lo = s[..., 12] >> LIMB_BITS
    u12 = lo + ((-s[..., 13] - lo) & MASK)
    u14 = (s[..., 14] + ((s[..., 13] + u12) >> LIMB_BITS)) >> LIMB_BITS
    high = s[..., NUM_LIMBS:]
    high[..., 0] += u14
    return _carry_limbs(high)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 (mod p); loose in, loose out: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors (the choice
    is ops/cuda_fq.mont_mul's)."""
    from . import cuda_fq  # cuda_fq imports this module

    return cuda_fq.mont_mul(a, b)


_LIMB_CONSTS = {"one": ONE_MONT, "mp": MP_LIMBS,
                "mp_plus_1": _int_to_limbs_np(MP + 1), "p": P_LIMBS,
                "n_prime": N_PRIME_LIMBS, "column": _COLUMN,
                "low_column": _LOW_COLUMN}
_P_MINUS_2_BITS = [int(b) for b in bin(P - 2)[2:]]


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """An int64 constant (15 limbs, or a product-column index map),
    uploaded once per device."""
    return torch.from_numpy(_LIMB_CONSTS[name].astype(np.int64)).to(device)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_limbs(a + b)


def compress(a: torch.Tensor) -> torch.Tensor:
    """Value-preserving magnitude reduction: one Montgomery multiply by the
    representation of 1 contracts any loose value to < 2^382."""
    return mont_mul(a, _const("one", a.device))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p), borrowless: a + MP + comp(b) + 1 == a + MP - b +
    2^420, with b compressed first so MP > b; the 2^420 overflow limb is
    dropped."""
    b = compress(b)
    t = a + _const("mp", a.device) + (MASK - b)
    t[..., 0] += 1
    return _carry_limbs(t, out_limbs=NUM_LIMBS + 1)[..., :NUM_LIMBS]


def add_many(terms) -> torch.Tensor:
    """Sum a list of loose elements (raw limb sums, one carry pass)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return _carry_limbs(acc)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def _geq_p(a: torch.Tensor) -> torch.Tensor:
    """a >= p on carried limbs, most significant limb first."""
    ge = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in reversed(range(NUM_LIMBS)):
        pk = int(P_LIMBS[k])
        gt = gt | (ge & (a[..., k] > pk))
        ge = ge & (a[..., k] == pk)
    return gt | ge


def _sub_p(a: torch.Tensor) -> torch.Tensor:
    """a - p with borrows, on carried limbs of a value >= p."""
    outs = []
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for k in range(NUM_LIMBS):
        cur = a[..., k] + (1 << LIMB_BITS) - int(P_LIMBS[k]) - borrow
        outs.append(cur & MASK)
        borrow = 1 - (cur >> LIMB_BITS)
    return torch.stack(outs, dim=-1)


def canonical(a: torch.Tensor) -> torch.Tensor:
    """The unique representative in [0, p): one Montgomery multiply by
    repr(1) (output < p + eps) and one conditional subtract."""
    r = mont_mul(a, _const("one", a.device))
    return torch.where(_geq_p(r)[..., None], _sub_p(r), r)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Mod-p zero test (canonicalizes internally)."""
    return (canonical(a) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canonical(a) == canonical(b)).all(dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None], a, b)


def pow_fixed(a: torch.Tensor, exp_bits) -> torch.Tensor:
    """a^e for a static msb-first bit list (loose in, loose out). On a CUDA
    tensor the whole chain is one launch of csrc/pow_chain.cu
    (ops/cuda_fq.pow_chain); elsewhere ``pow_fixed_steps``."""
    if a.device.type == "cuda":
        from . import cuda_fq  # cuda_fq imports this module

        return cuda_fq.pow_chain(a.contiguous(), exp_bits)
    return pow_fixed_steps(a, exp_bits)


def pow_fixed_steps(a: torch.Tensor, exp_bits) -> torch.Tensor:
    """The chain step by step: the top bit seeds the accumulator, each
    later bit costs a square, and a 1 bit a multiply by the base as well
    (the JAX package's lax.scan body computes that multiply at every bit
    and selects it away at a 0; the bits are static, so the product whose
    result the select drops is not made here, and the limbs are the
    same)."""
    acc = a
    for bit in exp_bits[1:]:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Modular inverse via Fermat: a^(p-2); inv(0) == 0."""
    return pow_fixed(a, _P_MINUS_2_BITS)


def const(x_int: int, batch_shape=(), *, device) -> torch.Tensor:
    c = torch.from_numpy(to_mont_int(x_int % P).astype(np.int64)).to(device)
    return c.expand(tuple(batch_shape) + (NUM_LIMBS,))
