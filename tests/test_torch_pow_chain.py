"""The exponentiation chain: ``fq.pow_fixed`` in the port, its kernel
(consensus_specs_tpu_torch/csrc/pow_chain.cu, wrapper
``ops/cuda_fq.pow_chain``) and the codec's stacked chains.

On the CPU, against the JAX package (tolerance 0, raw limbs):

- the plain chain ``fq.pow_fixed_steps`` (a product by the base only at a
  1 bit) against the JAX ``fq.pow_fixed`` (its lax.scan computes that
  product at every bit and selects it away at a 0), at 1, 7 and 64 rows,
  for both codec exponents and for an exponent of one bit, one with
  trailing zeros and one of all ones, with zero lanes and loose limbs near
  2^28 among the inputs;
- the kernel's lead-lane schedule (8 lanes a row up to 2,048 rows, 4
  above; the other lanes a round behind lane 0; a square a bit and a
  product by the base at a 1 bit) replayed in numpy lane by lane and
  round by round, carry pass included, against the plain chain and the
  JAX ``fq.pow_fixed`` on the same rows and exponents; one product of it
  at both lane counts against ``fq.mont_mul_plain`` on edge operands, its
  largest slot held under 2^62; its carry lookahead on carries that cross
  lanes of all-ones limbs;
- mont.cuh's split product (kernel 1's MUL unit) chained the same way, the
  schedule the chain kernel ran before its lead-lane product;
- the codec functions whose square roots now go in stacked chains
  (``_fq2_sqrt``, ``_g2_decode``, ``_sswu_map``) against the JAX codec's
  kernels;
- the wrapper's refusals, which need no card.

Marked ``cuda`` (skipped without a card; run on a GPU machine with
``python -m pytest tests/test_torch_pow_chain.py -m cuda``): the kernel
against the plain version at 1 to 8,192 rows, on
non-contiguous and 8-byte-offset operands, and beside a step-kernel stream
on another thread; the latency probe's clocks. The JAX package is imported
in the CPU cases only: the card's machine has no jax.
"""
import functools

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.ops import codec, cuda_fq, cuda_step, fq
from tests.torch_threads import one_thread

one_thread()

L = fq.NUM_LIMBS
ROWS = (1, 7, 64)
EXPONENTS = {
    "sqrt": codec._SQRT_BITS,
    "p_minus_2": fq._P_MINUS_2_BITS,
    "one_bit": [1],
    "trailing_zeros": [1, 0, 1, 1, 0, 1] + [0] * 34,
    "all_ones": [1] * 40,
}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's fq and codec modules on the CPU, the Montgomery
    product on its jnp uint64 lowering, each pow_fixed chain jitted once
    per shape and exponent (the codec kernels' bodies then run eagerly:
    compiling a whole kernel of square-root chains takes the XLA CPU
    compiler minutes)."""
    from consensus_specs_tpu.utils.jax_env import force_cpu

    force_cpu()
    import jax

    from consensus_specs_tpu.ops import codec as jcodec
    from consensus_specs_tpu.ops import fq as jfq

    mp = pytest.MonkeyPatch()
    mp.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    scan = jfq.pow_fixed

    @functools.partial(jax.jit, static_argnums=1)
    def jitted(a, bits):
        return scan(a, list(bits))

    mp.setattr(jfq, "pow_fixed", lambda a, bits: jitted(a, tuple(bits)))
    yield jfq, jcodec
    mp.undo()


def _inputs(rng, n):
    """(n, 15) limbs < 2^28: random loose values below 2^401, a zero lane,
    and lanes whose every limb is near 2^28 (values near 2^420)."""
    limbs = rng.integers(0, 1 << 28, size=(n, L), dtype=np.int64)
    limbs[:, 14] &= (1 << 9) - 1
    limbs[0] = 0
    if n > 1:
        limbs[1] = (1 << 28) - 1 - rng.integers(0, 16, size=L)
    if n > 2:
        limbs[2] = (1 << 28) - 1
    return limbs


def _canon(rng, shape):
    """Random canonical residues: limbs 0..12 uniform, limb 13 below p's,
    limb 14 zero."""
    limbs = rng.integers(0, 1 << 28, size=tuple(shape) + (L,), dtype=np.int64)
    limbs[..., 13] = rng.integers(0, int(fq.P_LIMBS[13]), size=shape)
    limbs[..., 14] = 0
    return limbs


def _same(got, want):
    """A port result (tensor or tuple) equal to a JAX one, raw limbs."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    assert np.array_equal(g.astype(w.dtype), w)


@pytest.mark.parametrize("name", list(EXPONENTS))
def test_plain_chain_matches_jax_pow_fixed(jax_side, name):
    """The plain chain at 1, 7 and 64 rows against one JAX chain over the
    same 72 rows; fq.pow_fixed on a CPU tensor is the plain chain and
    launches nothing."""
    import jax.numpy as jnp

    jfq, _ = jax_side
    bits = EXPONENTS[name]
    rng = np.random.default_rng(19 + len(bits))
    parts = [_inputs(rng, n) for n in ROWS]
    want = np.asarray(jfq.pow_fixed(
        jnp.asarray(np.concatenate(parts).astype(np.uint64)), bits))
    before = cuda_fq.CHAIN_LAUNCHES
    got = [fq.pow_fixed(torch.from_numpy(x), bits) for x in parts]
    assert cuda_fq.CHAIN_LAUNCHES == before
    _same(torch.cat(got), want)
    _same(fq.pow_fixed_steps(torch.from_numpy(parts[2]), bits),
          want[-ROWS[2]:])


def _split_chain_emulated(a, exp_bits):
    """mont.cuh's split product (cuda_step.mont_mul_split_emulated, whose
    result drops the 16th slot) chained as the chain kernel ran it before
    its lead-lane product: the exponent as the wrapper packs it
    (cuda_fq._chain_words), a square a bit and a product by the base at a
    1 bit."""
    n_bits = len(exp_bits) - 1
    words = list(cuda_fq._chain_words(tuple(exp_bits)))
    base = acc = np.asarray(a, dtype=np.uint64)
    for w in range(-(-n_bits // 32)):
        for i in range(min(32, n_bits - 32 * w)):
            acc = cuda_step.mont_mul_split_emulated(acc, acc)
            if (words[w] >> i) & 1:
                acc = cuda_step.mont_mul_split_emulated(acc, base)
    return acc


def test_split_schedule_chain_matches_plain():
    """A 41-bit exponent (two packed words, the second part-full) over 7
    rows with values near 2^420: the split product's chain equals the
    plain chain."""
    rng = np.random.default_rng(1919)
    bits = [1] + list(rng.integers(0, 2, 40))
    a = _inputs(rng, 7)
    want = fq.pow_fixed_steps(torch.from_numpy(a), bits).numpy()
    assert np.array_equal(_split_chain_emulated(a, bits).astype(np.int64),
                          want)


# ---------------------------------------------------------------------------
# the kernel's lead-lane product, replayed (csrc/pow_chain.cu
# pc_mont_mul_lead, pc_carry and pow_chain_lead_kernel)
# ---------------------------------------------------------------------------

LATENCY_ROWS = 2048  # PC_LATENCY_ROWS: 8 lanes a row up to it, 4 above
MASK, BITS = np.uint64(fq.MASK), np.uint64(fq.LIMB_BITS)
SLOT_LIMIT = 1 << 62  # mont.cuh's overflow audit: a column stays below


def _split_for(rows):
    return 8 if rows <= LATENCY_ROWS else 4


def _slots(x, split):
    """(..., 15) limbs -> (..., lane, slot) uint64, limb 15 zero."""
    x = np.asarray(x, dtype=np.uint64)
    pad = np.zeros(x.shape[:-1] + (16,), dtype=np.uint64)
    pad[..., :L] = x
    return pad.reshape(x.shape[:-1] + (split, 16 // split))


class _Slots:
    """uint64 adds that raise past SLOT_LIMIT (or on a wrap) and keep the
    largest sum seen."""

    def __init__(self):
        self.peak = 0

    def add(self, x, y):
        s = x + y
        if s.size:
            if np.any(s < x) or int(s.max()) >= SLOT_LIMIT:
                raise OverflowError("a slot past 2^62")
            self.peak = max(self.peak, int(s.max()))
        return s


def _carry_emulated(acc):
    """pc_carry: (n, lane, slot) columns -> normalized limbs. Each column's
    28-bit pieces summed within the lane, one shuffled carry up, then the
    ballots' carry-lookahead of the 0/1 carries."""
    n, split, slots = acc.shape
    lo, mid, hi = acc & MASK, (acc >> BITS) & MASK, acc >> (2 * BITS)
    out = np.zeros_like(acc)
    t = np.zeros((n, split), dtype=np.uint64)
    for r in range(slots):
        v = lo[:, :, r] + t
        if r >= 1:
            v = v + mid[:, :, r - 1]
        if r >= 2:
            v = v + hi[:, :, r - 2]
        assert int(v.max()) < 1 << 32
        out[:, :, r], t = v & MASK, v >> BITS
    c_lo = t + mid[:, :, -1] + hi[:, :, -2]
    in_lo = np.zeros_like(c_lo)  # __shfl_up_sync; lane 0 takes nothing
    in_hi = np.zeros_like(c_lo)
    in_lo[:, 1:], in_hi[:, 1:] = c_lo[:, :-1], hi[:, :-1, -1]
    v = out[:, :, 0] + in_lo
    out[:, :, 0], c = v & MASK, (v >> BITS) + in_hi
    for r in range(1, slots):
        v = out[:, :, r] + c
        out[:, :, r], c = v & MASK, v >> BITS
    gen = c != 0
    pro = np.all(out == MASK, axis=-1)
    assert not np.any(gen & pro)
    weights = np.uint64(1) << np.arange(split, dtype=np.uint64)
    g = (gen * weights).sum(axis=-1, dtype=np.uint64)  # the row's ballot bits
    gp = g | (pro * weights).sum(axis=-1, dtype=np.uint64)
    into = (gp + g) ^ gp ^ g
    c = (into[:, None] >> np.arange(split, dtype=np.uint64)) & np.uint64(1)
    for r in range(slots):
        v = out[:, :, r] + c
        out[:, :, r], c = v & MASK, v >> BITS
    return out


def _lead_mul_emulated(af, b, audit):
    """pc_mont_mul_lead over (n,) rows: af (n, 15) the whole a (every lane
    holds it), b (n, lane, slot) lane q's limbs -> the product's
    (n, lane, slot) limbs, the top slot zeroed as the kernel does. Lane 0
    does digit i in round i from its own column i; the other lanes digit
    i-1 with m_{i-1} shuffled from lane 0 a round earlier; each lane's
    slot 0 low word goes to the lane below, added there a round later
    (lane 0's slot SLOTS-2, the others' slot SLOTS-1). With 2 slots the
    kernel hands slot 0 down at the start of the round, once its last
    term m_{i-1} * p_0 is known: the same word, earlier."""
    n, split, slots = b.shape
    p = _slots(fq.P_LIMBS, split)[None]
    lead = (np.arange(split) == 0)[None, :]
    add = audit.add
    acc = np.zeros((n, split, slots), dtype=np.uint64)
    acc[:, 0, :] = af[:, :1] * b[:, 0, :]
    mprev = np.zeros((n, split), dtype=np.uint64)
    inc = np.zeros((n, split), dtype=np.uint64)
    for i in range(L + 1):
        if i > 0:
            acc[:, 0, -2] = add(acc[:, 0, -2], inc[:, 0])
            acc[:, 1:, -1] = add(acc[:, 1:, -1], inc[:, 1:])
        own = ((acc[:, :, 0] & MASK) * np.uint64(fq.N0)) & MASK
        m = np.where(lead, own, mprev) if i < L else mprev
        top = np.zeros((n, split), dtype=np.uint64)
        if i < L:  # the next round's a-terms, in their slots after the shift
            nxt_a = af[:, i + 1] if i + 1 < L else np.zeros(n, np.uint64)
            an = np.where(lead, nxt_a[:, None], af[:, i][:, None])
            acc[:, :, 1:] = add(acc[:, :, 1:], an[:, :, None] * b[:, :, :-1])
            top = an * b[:, :, -1]
        acc = add(acc, m[:, :, None] * p)
        if i < L:  # __shfl_sync(m, 0): lane 0's m, for the other lanes
            mprev = np.where(lead, np.uint64(0), m[:, :1])
        hi = acc[:, :, 0] >> BITS
        inc = np.zeros((n, split), dtype=np.uint64)  # __shfl_down_sync
        inc[:, :-1] = acc[:, 1:, 0] & MASK
        shifted = np.concatenate([acc[:, :, 1:], top[:, :, None]], axis=-1)
        shifted[:, :, 0] = add(shifted[:, :, 0], hi)
        # round 15: lane 0 has done its 15 digits and keeps its columns
        acc = shifted if i < L else np.where(lead[:, :, None], acc, shifted)
    acc[:, :, -1] = add(acc[:, :, -1], inc)
    out = _carry_emulated(acc)
    out[:, -1, -1] = 0
    return out


def _lead_chain_emulated(a, exp_bits, split=None, audit=None):
    """pow_chain_lead_kernel row for row, at the lanes a row the launch
    takes for these rows: the exponent packed by the wrapper
    (cuda_fq._chain_words), a square a bit (a = the accumulator gathered
    from the lanes) and a product by the base at a 1 bit (a = the base); b
    is the accumulator's slots either way."""
    audit = audit or _Slots()
    base = np.asarray(a, dtype=np.uint64).reshape(-1, L)
    split = split or _split_for(base.shape[0])
    words = list(cuda_fq._chain_words(tuple(exp_bits)))
    acc = _slots(base, split)
    for i in range(len(exp_bits) - 1):
        acc = _lead_mul_emulated(acc.reshape(-1, 16)[:, :L], acc, audit)
        if (words[i // 32] >> (i % 32)) & 1:
            acc = _lead_mul_emulated(base, acc, audit)
    return acc.reshape(-1, 16)[:, :L]


@pytest.mark.parametrize("name", list(EXPONENTS))
def test_lead_schedule_chain_matches_jax_pow_fixed(jax_side, name):
    """The kernel's schedule over the 1-, 7- and 64-row inputs of the
    plain chain's test (zero lanes, limbs near 2^28), 8 lanes a row as the
    launch takes these rows, against the JAX chain over the same rows and
    the plain chain, raw limbs; the 4-lane schedule of wider launches
    against the plain chain on the same rows."""
    import jax.numpy as jnp

    jfq, _ = jax_side
    bits = EXPONENTS[name]
    rng = np.random.default_rng(19 + len(bits))
    parts = [_inputs(rng, n) for n in ROWS]
    rows = np.concatenate(parts)
    want = np.asarray(jfq.pow_fixed(jnp.asarray(rows.astype(np.uint64)),
                                    bits)).astype(np.int64)
    assert np.array_equal(
        want, fq.pow_fixed_steps(torch.from_numpy(rows), bits).numpy())
    got = np.concatenate([_lead_chain_emulated(x, bits) for x in parts])
    assert np.array_equal(got.astype(np.int64), want)
    wide = _lead_chain_emulated(rows, bits, split=_split_for(LATENCY_ROWS + 1))
    assert np.array_equal(wide.astype(np.int64), want)


@pytest.mark.parametrize("split", [8, 4])
def test_lead_product_on_edge_operands(split):
    """One lead-lane product, a square and a product of distinct
    operands, on every pair of all limbs 2^28 - 1, p - 1 and 0 (and
    random loose rows) against fq.mont_mul_plain; the largest slot it
    forms stays under 2^62, so no 64-bit column wraps."""
    rng = np.random.default_rng(2020)
    p_minus_1 = fq.P_LIMBS.astype(np.int64)
    p_minus_1[0] -= 1
    edge = np.stack([np.full(L, int(fq.MASK), np.int64), p_minus_1,
                     np.zeros(L, np.int64)])
    loose = lambda: rng.integers(0, 1 << 28, size=(8, L), dtype=np.int64)
    x = np.concatenate([np.repeat(edge, 3, axis=0), loose()])
    y = np.concatenate([np.tile(edge, (3, 1)), loose()])
    audit = _Slots()
    for a, b in ((x, y), (x, x)):
        want = fq.mont_mul_plain(torch.from_numpy(a), torch.from_numpy(b))
        got = _lead_mul_emulated(a.astype(np.uint64), _slots(b, split), audit)
        assert np.array_equal(got.reshape(-1, 16)[:, :L].astype(np.int64),
                              want.numpy())
    assert 1 << 56 < audit.peak < SLOT_LIMIT  # sums of products, not one


def test_carry_lookahead_ripples_through_all_ones_lanes():
    """pc_carry on columns whose carry must cross lanes of all-ones limbs
    (and, in the top lane, leave the row): the lookahead's limbs are the
    plain carried limbs of the columns' integer, mod 2^448."""
    rng = np.random.default_rng(2021)
    for split in (8, 4):
        slots = 16 // split
        acc = np.full((6, split, slots), int(fq.MASK), dtype=np.uint64)
        acc[0, 0, 0] += np.uint64(1)            # a carry through every lane
        acc[1, 0, :] = np.uint64((1 << 61) + 12345)  # big columns in lane 0
        acc[2] = rng.integers(0, 1 << 61, size=(split, slots),
                              dtype=np.uint64)
        acc[3, split // 2, 0] = np.uint64(1 << 60)
        acc[4] = 0
        acc[5, :, :] = rng.integers(0, 1 << 28, size=(split, slots),
                                    dtype=np.uint64)
        got = _carry_emulated(acc.copy()).reshape(6, 16)
        for row, limbs in zip(acc.reshape(6, 16), got):
            value = sum(int(x) << (28 * k) for k, x in enumerate(row))
            want = [(value >> (28 * k)) & int(fq.MASK) for k in range(16)]
            assert limbs.tolist() == want


def test_chain_words_pack_the_tail_first_bit_first():
    words = cuda_fq._chain_words((1, 1, 0, 1) + (0,) * 29 + (1,))
    assert list(words) == [0b101, 1]
    assert list(cuda_fq._chain_words((1,))) == [0]


def test_codec_stacks_its_square_roots(jax_side, monkeypatch):
    """_fq2_sqrt on 4 Fq2 values (the non-residue 1 + u, a square, a b == 0
    lane, zero): two square-root pow_fixed calls of 3 and 2 stacked
    chains, and the JAX codec's roots and flags, raw limbs."""
    import jax.numpy as jnp

    _, jcodec = jax_side
    rng = np.random.default_rng(1920)
    v = _canon(rng, (4, 2))
    v[0] = jcodec._fq2_const_np(jcodec.O.Fq2(1, 1))
    v[1] = jcodec._fq2_const_np(jcodec.O.Fq2(5, 9).square())
    v[2, 1] = 0
    v[3] = 0
    calls = []
    real = fq.pow_fixed

    def counted(a, bits):
        calls.append((tuple(a.shape), len(bits)))
        return real(a, bits)

    monkeypatch.setattr(fq, "pow_fixed", counted)
    got = codec._fq2_sqrt(torch.from_numpy(v))
    sqrt_calls = [s for s, n in calls if n == len(codec._SQRT_BITS)]
    assert sqrt_calls == [(3, 4, L), (2, 4, L)]
    _same(got, jcodec._fq2_sqrt(jnp.asarray(v.astype(np.uint64))))
    assert got[1].tolist() == [False, True, True, True]


def test_g2_decode_matches_the_jax_kernel(jax_side):
    import jax.numpy as jnp

    _, jcodec = jax_side
    x_raw = _canon(np.random.default_rng(1921), (4, 2))
    x_raw[3, 1] = 0
    _same(codec._g2_decode(torch.from_numpy(x_raw)),
          jcodec._g2_decode_kernel.__wrapped__(
              jnp.asarray(x_raw.astype(np.uint64))))


def test_sswu_map_matches_the_jax_kernel(jax_side):
    """u = 0 included (tv2 == 0 takes the exceptional x1)."""
    import jax.numpy as jnp

    _, jcodec = jax_side
    u = _canon(np.random.default_rng(1922), (4, 2))
    u[2] = 0
    _same(codec._sswu_map(torch.from_numpy(u)),
          jcodec._sswu_map_kernel.__wrapped__(
              jnp.asarray(u.astype(np.uint64))))


@pytest.mark.parametrize("bad, error", [
    (lambda: torch.zeros(4, L, dtype=torch.int32), TypeError),
    (lambda: torch.zeros(4, L - 1, dtype=torch.int64), ValueError),
    (lambda: torch.zeros(L, 4, dtype=torch.int64).t(), ValueError),
    (lambda: torch.zeros((), dtype=torch.int64), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    before = cuda_fq.CHAIN_LAUNCHES
    with pytest.raises(error):
        cuda_fq.pow_chain(bad(), codec._SQRT_BITS)
    with pytest.raises(ValueError):
        cuda_fq.pow_chain(torch.zeros(2, L, dtype=torch.int64),
                          [1] * (cuda_fq.CHAIN_MAX_BITS + 2))
    assert cuda_fq.CHAIN_LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64, 128, 512, 2048, 2049, 8192])
def test_kernel_matches_plain(dev, rows):
    """One launch a chain, limb for limb the plain chain on the CPU, at
    both exponents (the square root at every row count); 2048 and 2049
    rows are the last at 8 lanes a row and the first at 4."""
    rng = np.random.default_rng(rows)
    x = _inputs(rng, rows)
    for bits in (codec._SQRT_BITS, fq._P_MINUS_2_BITS):
        if bits is fq._P_MINUS_2_BITS and rows > 512:
            continue
        before = cuda_fq.CHAIN_LAUNCHES
        got = cuda_fq.pow_chain(torch.from_numpy(x).to(dev), bits)
        assert cuda_fq.CHAIN_LAUNCHES == before + 1
        want = fq.pow_fixed_steps(torch.from_numpy(x), bits)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_on_strided_and_offset_operands(dev):
    """fq.pow_fixed on a non-contiguous view (the wrapper itself refuses
    one) and on rows that start 8 bytes past a 16-byte boundary; batch
    shapes (15,) and (64, 2, 15) come back in their shapes."""
    rng = np.random.default_rng(1923)
    bits = codec._SQRT_BITS
    x = torch.from_numpy(_inputs(rng, 64)).to(dev)
    view = torch.stack([x, x.flip(0)], dim=1)[:, 1]  # strided rows
    assert not view.is_contiguous()
    with pytest.raises(ValueError):
        cuda_fq.pow_chain(view, bits)
    assert torch.equal(fq.pow_fixed(view, bits).cpu(),
                       fq.pow_fixed_steps(view.cpu(), bits))
    buf = torch.from_numpy(_inputs(rng, 33).reshape(-1)).to(dev)
    off = buf[1:1 + 32 * L].view(32, L)
    assert off.data_ptr() % 16 == 8
    assert torch.equal(cuda_fq.pow_chain(off, bits).cpu(),
                       fq.pow_fixed_steps(off.cpu(), bits))
    for shape in ((L,), (64, 2, L)):
        a = torch.from_numpy(_inputs(rng, int(np.prod(shape)) // L)
                             .reshape(shape)).to(dev)
        got = fq.pow_fixed(a, bits)
        assert got.shape == a.shape
        assert torch.equal(got.cpu(), fq.pow_fixed_steps(a.cpu(), bits))


@pytest.mark.cuda
def test_chain_beside_a_step_kernel_stream(dev):
    """Two threads, each on its own stream: one launches chains of a new
    exponent, while the other launches the step kernel on the first 256
    steps of a real program again and again, synchronizing its stream
    after each launch. No CUDA error; every result equals its plain
    version limb for limb; the counters equal the sums of what the two
    threads launched (no kernel-2 launch: a chain is one launch of its
    own kernel)."""
    import threading

    from consensus_specs_tpu_torch.ops import bls_backend, vm

    rng = np.random.default_rng(41)
    bits = [1] + list(rng.integers(0, 2, 47))
    xs = [torch.from_numpy(_inputs(rng, 33)).to(dev) for _ in range(4)]
    program, _ = bls_backend._program("hard_part_frobenius", 0, 1)
    instr = tuple(x[:256].contiguous() for x in program.device_instr(dev))
    regs = torch.from_numpy(_canon(rng, (2, program.n_regs)))
    want_regs = vm._run_steps_plain(regs.clone(), tuple(
        x.cpu() for x in instr))
    regs = regs.to(dev)

    chain_out, step_out, errors = [], [], []
    chain_done = threading.Event()
    start = threading.Barrier(2)

    def chains():
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                start.wait()
                for x in xs:
                    chain_out.append(fq.pow_fixed(x, bits))
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # reported below, not lost in the thread
            errors.append(e)
        finally:
            chain_done.set()

    def steps():
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                start.wait()
                while not chain_done.is_set() or len(step_out) < 4:
                    step_out.append(cuda_step.run_steps(regs.clone(), instr))
                    torch.cuda.current_stream().synchronize()
        except Exception as e:
            errors.append(e)

    fq0, chain0 = cuda_fq.LAUNCHES, cuda_fq.CHAIN_LAUNCHES
    st0, steps0 = cuda_step.LAUNCHES, cuda_step.STEPS
    threads = [threading.Thread(target=f) for f in (chains, steps)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    assert not errors, errors
    for x, got in zip(xs, chain_out):
        assert torch.equal(got.cpu(), fq.pow_fixed_steps(x.cpu(), bits))
    assert all(torch.equal(r.cpu(), want_regs) for r in step_out)
    assert cuda_fq.CHAIN_LAUNCHES - chain0 == len(xs)
    assert cuda_fq.LAUNCHES == fq0
    assert cuda_step.LAUNCHES - st0 == len(step_out)
    assert cuda_step.STEPS - steps0 == 256 * len(step_out)


@pytest.mark.cuda
def test_probe_clocks_are_positive(dev):
    """The latency probe times each of its chains (a dependent wide
    multiply-add, a dependent shuffle, the REDC digit step): every one a
    positive clock count, and no chain launch counted."""
    before = cuda_fq.CHAIN_LAUNCHES
    clocks = cuda_fq.chain_probe(dev)
    assert set(clocks) == set(cuda_fq.PROBE_CHAINS)
    assert all(c > 0 for c in clocks.values()), clocks
    assert cuda_fq.CHAIN_LAUNCHES == before
