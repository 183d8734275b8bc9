"""The port's 32-bit-lane field arithmetic (consensus_specs_tpu_torch/
ops/fq32.py) against the JAX package's ops/fq32.py on the CPU: the six
cases of tests/test_ops_fq32.py, each output's limbs equal to the JAX
module's uint32 limbs (tolerance 0) and its value the exact-int
oracle's. In place of the JAX file's "compiles without x64": the port's
lanes are ``torch.int32`` on every output, and the same code rerun in
int64 sees every column it carries below 2^31 (so the int32 run cannot
have wrapped) and gives the same limbs."""
from random import Random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fq32 as jfq32
from consensus_specs_tpu_torch.ops import fq32
from consensus_specs_tpu_torch.utils.bls12_381 import P
from tests.torch_threads import one_thread

one_thread()


def _rand(rng):
    return rng.randrange(P)


def _same(got, want):
    """Port int32 lanes equal the JAX module's uint32 limbs."""
    assert got.dtype == fq32.DTYPE == torch.int32
    want = np.asarray(want)
    assert want.dtype == np.uint32
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


def test_limb_roundtrip():
    rng = Random(321321)
    for _ in range(10):
        x = _rand(rng)
        limbs = fq32._int_to_limbs_np(x)
        assert np.array_equal(limbs, jfq32._int_to_limbs_np(x))
        assert fq32.limbs_to_int(limbs) == x
    assert fq32.from_mont_limbs(fq32.to_mont_int(12345)) == 12345
    assert np.array_equal(fq32.P_LIMBS, jfq32.P_LIMBS)
    assert np.array_equal(fq32.ONE_MONT, jfq32.ONE_MONT)
    assert np.array_equal(fq32.MP_LIMBS, jfq32.MP_LIMBS)
    assert fq32.N0 == jfq32.N0


def test_mont_mul_matches_reference():
    rng = Random(321322)
    for _ in range(20):
        a, b = fq32.to_mont_int(_rand(rng)), fq32.to_mont_int(_rand(rng))
        got = fq32.mont_mul(a, b)
        _same(got, jfq32.mont_mul(a, b))
        assert fq32.from_mont_limbs(got) == (fq32.from_mont_limbs(a)
                                             * fq32.from_mont_limbs(b)) % P


def test_add_sub_match_reference():
    rng = Random(321323)
    for _ in range(20):
        a, b = _rand(rng), _rand(rng)
        am, bm = fq32.to_mont_int(a), fq32.to_mont_int(b)
        s = fq32.add(am, bm)
        _same(s, jfq32.add(am, bm))
        assert fq32.from_mont_limbs(s) == (a + b) % P
        d = fq32.sub(am, bm)
        _same(d, jfq32.sub(am, bm))
        assert fq32.from_mont_limbs(d) == (a - b) % P


def _chain(mod, a_int):
    """The JAX file's 30-step chain of muls, adds and subs."""
    acc = mod.to_mont_int(1)
    a = mod.to_mont_int(a_int)
    outs = []
    for i in range(30):
        if i % 3 == 0:
            acc = mod.mont_mul(acc, a)
        elif i % 3 == 1:
            acc = mod.add(acc, a)
        else:
            acc = mod.sub(acc, a)
        outs.append(acc)
    return outs


def test_chained_ops_match_reference_and_stay_bounded():
    a_int = _rand(Random(321324))
    got, want = _chain(fq32, a_int), _chain(jfq32, a_int)
    acc_int = 1
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w)
        assert int(g.max()) < (1 << 31)
        acc_int = ((acc_int * a_int) if i % 3 == 0 else
                   (acc_int + a_int) if i % 3 == 1 else
                   (acc_int - a_int)) % P
    assert fq32.from_mont_limbs(got[-1]) == acc_int


def test_canonical_and_batched_match_reference():
    rng = Random(321325)
    xs = [_rand(rng) for _ in range(8)]
    batch = np.stack([fq32.to_mont_int(x) for x in xs])
    sq = fq32.mont_mul(batch, batch)
    _same(sq, jfq32.mont_mul(batch, batch))
    for i, x in enumerate(xs):
        assert fq32.from_mont_limbs(sq[i]) == x * x % P
    canon = fq32.canonical(batch)
    _same(canon, jfq32.canonical(batch))
    for i, x in enumerate(xs):
        # canonical() reduces the MONTGOMERY representative to [0, p)
        assert fq32.limbs_to_int(canon[i]) == (x * fq32.R_MONT) % P


def test_every_carried_column_fits_int32(monkeypatch):
    """The int32 lanes' bound: every column ``_carry_limbs`` sees (all the
    sums and products mont_mul, add, sub and canonical form pass through
    it) is below 2^31 in an int64 rerun on adversarial inputs (all limbs
    at 2^12 - 1), and the rerun's limbs equal the int32 run's."""
    rng = Random(321326)
    full = np.full(fq32.NUM_LIMBS, fq32.MASK, dtype=np.uint32)
    xs = [full, fq32.P_LIMBS.copy()] + [fq32.to_mont_int(_rand(rng))
                                        for _ in range(6)]
    batch = np.stack(xs)
    other = np.roll(batch, 1, axis=0)
    ops = {"mont_mul": lambda m: m.mont_mul(batch, other),
           "add": lambda m: m.add(batch, other),
           "sub": lambda m: m.sub(batch, other),
           "canonical": lambda m: m.canonical(batch)}
    narrow = {name: op(fq32) for name, op in ops.items()}
    peak = []
    carry = fq32._carry_limbs

    def watched(t, out_limbs=fq32.NUM_LIMBS):
        peak.append(int(t.max()))
        assert int(t.min()) >= 0
        return carry(t, out_limbs)

    monkeypatch.setattr(fq32, "DTYPE", torch.int64)
    monkeypatch.setattr(fq32, "_carry_limbs", watched)
    for name, op in ops.items():
        wide = op(fq32)
        assert wide.dtype == torch.int64
        assert torch.equal(wide, narrow[name].to(torch.int64)), name
        assert np.array_equal(wide.numpy(),
                              np.asarray(op(jfq32)).astype(np.int64)), name
    assert peak and max(peak) < (1 << 31)


@pytest.mark.parametrize("name", ["mont_mul", "add", "sub", "canonical"])
def test_outputs_stay_int32(name):
    """In place of the JAX file's no-x64 compile: the port's lanes never
    widen, whatever the inputs' dtype (numpy uint32, int64 tensors)."""
    a = fq32.to_mont_int(5)
    b = torch.from_numpy(fq32.to_mont_int(7).astype(np.int64))
    fn = getattr(fq32, name)
    out = fn(a) if name == "canonical" else fn(a, b)
    assert out.dtype == torch.int32
