"""Base-field (Fq) limb arithmetic in 32-bit lanes: the counterpart of
consensus_specs_tpu/ops/fq32.py, limb for limb.

  - 32 limbs x 12 bits (384 bits capacity, p is 381 bits)
  - limb products < 2^24; a schoolbook column accumulates <= 32 of them
    plus reduction terms, and every intermediate stays below 2^31
  - the loose-Montgomery conventions of ops/fq.py (R = 2^384 here), the
    same API subset (mont_mul / add / sub / canonical / conversions)

The JAX module runs in uint32. Torch's unsigned tensors do not add or
shift, so this one runs in ``torch.int32``: the JAX module's own bound
(every value below 2^31) makes the signed lanes exact, and its results
are the JAX module's uint32 limbs. tests/test_torch_fq32.py reruns the
code in int64 and asserts the bound on every column this module carries.
The JAX package has no Pallas kernel here: this is plain PyTorch on any
device.
"""
import numpy as np
import torch

from ..utils.bls12_381 import P

LIMB_BITS = 12
NUM_LIMBS = 32
MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # 384
R_MONT = 1 << R_BITS

DTYPE = torch.int32


def _int_to_limbs_np(x: int) -> np.ndarray:
    out = np.zeros(NUM_LIMBS, dtype=np.uint32)
    for i in range(NUM_LIMBS):
        out[i] = x & MASK
        x >>= LIMB_BITS
    assert x == 0, "value exceeds 384-bit capacity"
    return out


def limbs_to_int(limbs) -> int:
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs)
    x = 0
    for i in reversed(range(limbs.shape[-1])):
        x = (x << LIMB_BITS) | int(limbs[..., i])
    return x


P_LIMBS = _int_to_limbs_np(P)
N0 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)  # -p^-1 mod 2^12
ONE_MONT = _int_to_limbs_np(R_MONT % P)


def to_mont_int(x: int) -> np.ndarray:
    return _int_to_limbs_np((x * R_MONT) % P)


R_INV = pow(R_MONT, -1, P)


def from_mont_limbs(limbs) -> int:
    return (limbs_to_int(limbs) * R_INV) % P


def _lanes(a, like=None) -> torch.Tensor:
    """Limbs (a tensor or an array) as a DTYPE tensor, on ``like``'s
    device when given."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a).astype(np.int64))
    device = like.device if like is not None else a.device
    return a.to(device=device, dtype=DTYPE)


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int64)).to(device=like.device,
                                                     dtype=like.dtype)


def _carry_limbs(t: torch.Tensor, out_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Propagate carries to limbs < 2^12. Column values must be < 2^31."""
    n = t.shape[-1]
    outs = []
    c = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for k in range(n):
        cur = t[..., k] + c
        outs.append(cur & MASK)
        c = cur >> LIMB_BITS
    while len(outs) < out_limbs:
        outs.append(c & MASK)
        c = c >> LIMB_BITS
    return torch.stack(outs[:out_limbs], dim=-1)


def _shifted(vec: torch.Tensor, offset: int, total: int) -> torch.Tensor:
    return torch.nn.functional.pad(vec, (offset, total - vec.shape[-1] - offset))


def mont_mul(a, b) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p in 32-bit lanes.

    Overflow audit: tight limbs are < 2^12 (inputs are carry-normalized),
    so schoolbook columns accumulate <= 32 products < 2^24 => < 2^29; the
    reduction adds one m*P_limb (< 2^24) per outer step per column plus a
    carry => every column stays < 2^31."""
    a = _carry_limbs(_lanes(a))  # enforce tight limbs
    b = _carry_limbs(_lanes(b, a))
    a, b = torch.broadcast_tensors(a, b)
    total = 2 * NUM_LIMBS + 1

    t = None
    for i in range(NUM_LIMBS):
        row = a[..., i : i + 1] * b  # products < 2^24
        t = _shifted(row, i, total) if t is None else t + _shifted(row, i, total)
        if (i + 1) % 8 == 0:
            # re-normalize every 8 rows so columns never approach 2^31:
            # 8 rows add < 8 * 2^24 = 2^27 on top of < 2^13 carried limbs
            t = _carry_limbs(t, out_limbs=total)

    t = _carry_limbs(t, out_limbs=total)
    p = _const(P_LIMBS, t)
    for i in range(NUM_LIMBS):
        ti = t[..., i]
        m = ((ti & MASK) * N0) & MASK  # < 2^12
        add_ = m[..., None] * p  # products < 2^24
        carry = (ti + m * int(P_LIMBS[0])) >> LIMB_BITS
        vec = torch.cat([add_[..., 1:2] + carry[..., None], add_[..., 2:]],
                        dim=-1)
        t = t + _shifted(vec, i + 1, total)
        if (i + 1) % 8 == 0:
            # renormalize the UNPROCESSED suffix only: processed columns
            # <= i hold stale residuals that the final slice drops; carrying
            # them upward would double-count each cleared limb
            suffix = _carry_limbs(t[..., i + 1:], out_limbs=total - (i + 1))
            t = torch.cat([torch.zeros_like(t[..., : i + 1]), suffix], dim=-1)

    return _carry_limbs(t[..., NUM_LIMBS : 2 * NUM_LIMBS + 1])


def add(a, b) -> torch.Tensor:
    a = _lanes(a)
    return _carry_limbs(a + _lanes(b, a))


# smallest multiple of p above 2^382 (a compressed subtrahend is < 2^382)
MP = ((1 << 382) // P + 1) * P
MP_LIMBS = _int_to_limbs_np(MP)


def compress(a) -> torch.Tensor:
    """Contract any loose value to < 2^382 via one Montgomery multiply."""
    a = _lanes(a)
    return mont_mul(a, _const(ONE_MONT, a))


def sub(a, b) -> torch.Tensor:
    """a - b (mod p), borrowless: a + MP + comp(b) + 1 - 2^384."""
    a = _carry_limbs(_lanes(a))
    b = compress(_lanes(b, a))
    nb = MASK - b
    t = a + _const(MP_LIMBS, a) + nb
    t[..., 0] += 1
    limbs = _carry_limbs(t, out_limbs=NUM_LIMBS + 1)
    return limbs[..., :NUM_LIMBS]


def _geq_p(a: torch.Tensor) -> torch.Tensor:
    ge = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in reversed(range(NUM_LIMBS)):
        pk = int(P_LIMBS[k])
        gt = gt | (ge & (a[..., k] > pk))
        ge = ge & (a[..., k] == pk)
    return gt | ge


def _sub_p(a: torch.Tensor) -> torch.Tensor:
    outs = []
    borrow = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for k in range(NUM_LIMBS):
        cur = a[..., k] + (1 << LIMB_BITS) - int(P_LIMBS[k]) - borrow
        outs.append(cur & MASK)
        borrow = 1 - (cur >> LIMB_BITS)
    return torch.stack(outs, dim=-1)


def canonical(a) -> torch.Tensor:
    a = _lanes(a)
    r = mont_mul(a, _const(ONE_MONT, a))
    return torch.where(_geq_p(r)[..., None], _sub_p(r), r)
