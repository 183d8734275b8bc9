"""The port's reference-slow final exponentiation
(``pairing.final_exp_is_one_full``: square-and-multiply over the whole
~4314-bit exponent) against its structured one (``final_exp_is_one``,
held against the JAX backend's exact-int verdict in
tests/test_torch_pairing_twins.py) on 1 row each of a valid and a
corrupted Miller product, on the CPU."""
import random

import numpy as np

from consensus_specs_tpu_torch.ops import fq, pairing, towers
from consensus_specs_tpu_torch.utils import bls12_381 as O
from tests.torch_threads import one_thread

one_thread()


def _limbs(pt):
    x, y = O.ec_to_affine(pt)
    if isinstance(x, O.Fq2):
        return (fq.limbs_from_numpy(np.stack([fq.to_mont_int(x.c0),
                                              fq.to_mont_int(x.c1)]), "cpu"),
                fq.limbs_from_numpy(np.stack([fq.to_mont_int(y.c0),
                                              fq.to_mont_int(y.c1)]), "cpu"))
    return (fq.limbs_from_numpy(fq.to_mont_int(x.n), "cpu"),
            fq.limbs_from_numpy(fq.to_mont_int(y.n), "cpu"))


def test_final_exp_full_agrees_with_the_structured_one():
    a = 6
    p1 = _limbs(O.ec_mul(O.G1_GEN, a))
    q1 = _limbs(O.G2_GEN)
    p2 = _limbs(O.ec_neg(O.G1_GEN))
    q2 = _limbs(O.ec_mul(O.G2_GEN, a))
    f = towers.fq12_mul(
        pairing.miller_loop(q1[0][None], q1[1][None], p1[0][None],
                            p1[1][None]),
        pairing.miller_loop(q2[0][None], q2[1][None], p2[0][None],
                            p2[1][None]))
    rng = random.Random(74)
    noise = np.stack([fq.to_mont_int(rng.randrange(O.P)) for _ in range(12)])
    for row, want in ((f, True),
                      (towers.fq12_mul(f, fq.limbs_from_numpy(noise, "cpu")),
                       False)):
        full = pairing.final_exp_is_one_full(row).tolist()
        assert full == pairing.final_exp_is_one(row).tolist() == [want]
