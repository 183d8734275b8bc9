"""Hard-part variant bit-identity canary: the port's counterpart of
consensus_specs_tpu/ops/finalexp_smoke.py.

    python -m consensus_specs_tpu_torch.ops.finalexp_smoke [--device cpu]

Holds the windowed and Frobenius hard-part VM programs to BIT-IDENTITY
against the exact-int host oracle over an input matrix that covers valid
and adversarial Fq12 classes:

  - the identity (every variant must map 1 -> 1);
  - random unitary elements (easy-part images of random Fq12) and a
    conjugate;
  - REAL verification flows: easy-part images of genuine Miller outputs
    (PROG A on the same device), one valid committee check and one
    corrupted-signature check (the input an attacker controls reaches
    the hard part only through the easy part, so it is always unitary);
  - raw NON-unitary Fq12 fed straight in, bypassing the easy part. The
    cyclotomic squarings inside every variant equal true squarings only
    on unitary elements, so there is no exact-int twin for these: they
    are held to the two contracts that matter, res must NOT equal 1 (no
    false accept) and the output must be deterministic (bit-equal across
    executions).

Unitary comparisons are on the full 12-coefficient result (exact integers
after Montgomery decode) against BOTH the HHT chain and, for the
frobenius variant, an independent exact-int evaluation of its lambda
decomposition; the ==1 verdict is also checked against bls_backend's
oracle HHT. The flight recorder is armed for the run (and the caller's
environment restored afterwards); on a failure its journal dumps to
``finalexp_flight.jsonl`` (gitignored) unless
CONSENSUS_SPECS_TPU_FLIGHT_DUMP names another path. Without ``--device
cpu`` it runs on the card (every VM execution one step-kernel launch),
and exits non-zero without one. Exit 0 on a pass; nonzero with a
diagnosis line otherwise.
"""
import os
import random
import sys

SEED = int(os.environ.get("FINALEXP_SMOKE_SEED", "11"))

_ENV = ("CONSENSUS_SPECS_TPU_FLIGHT", "CONSENSUS_SPECS_TPU_FLIGHT_DUMP")


def main(device=None) -> int:
    prev_env = {k: os.environ.get(k) for k in _ENV}
    os.environ["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"
    os.environ.setdefault("CONSENSUS_SPECS_TPU_FLIGHT_DUMP",
                          "finalexp_flight.jsonl")
    try:
        return _run(device)
    finally:
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(device) -> int:
    from ..device import resolve_device
    from ..obs import flight
    from ..utils import bls
    from ..utils import bls12_381 as O
    from . import bls_backend as bb, fq, vm, vmlib

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"finalexp-smoke: {e}")
        return 2
    rng = random.Random(SEED)

    def rand_fq12():
        def r2():
            return O.Fq2(rng.randrange(O.P), rng.randrange(O.P))

        return O.Fq12(O.Fq6(r2(), r2(), r2()), O.Fq6(r2(), r2(), r2()))

    def easy(f):
        g = f.conjugate() * f.inverse()
        return g.frobenius().frobenius() * g

    def oracle_pow(t, bits):
        acc = t
        for b in bits[1:]:
            acc = acc * acc
            if b:
                acc = acc * t
        return acc

    # the one shared exact-int HHT chain (bls_backend owns the formula;
    # the smoke gates against the SAME oracle production uses)
    oracle_res = bb.hard_part_res_oracle

    def oracle_res_frobenius(g):
        """The lambda decomposition evaluated directly in exact ints: the
        frobenius variant's own formula, independently of the VM."""
        abs_x = -vmlib.X_PARAM

        def bits(e):
            return [int(b) for b in bin(e)[2:]]

        A = oracle_pow(g, bits((abs_x + 1) ** 2))
        B = oracle_pow(A, bits(abs_x))
        C = oracle_pow(B, bits(abs_x))
        D = oracle_pow(C, bits(abs_x))
        e0 = D.conjugate() * B * (g * g * g)
        e1 = (C * A.conjugate()).frobenius()
        e2 = B.conjugate().frobenius().frobenius()
        e3 = A.frobenius().frobenius().frobenius()
        return e0 * e1 * e2 * e3

    # -- input matrix -------------------------------------------------------
    f0 = rand_fq12()
    one = f0 * f0.inverse()
    unitary_cases = [
        ("identity", one),
        ("random-unitary-1", easy(rand_fq12())),
        ("random-unitary-2", easy(rand_fq12())),
        ("conjugate", easy(rand_fq12()).conjugate()),
    ]
    # real verification flows: a valid and a corrupted committee check
    sks = [41, 42]
    pks = [bls.SkToPk(sk) for sk in sks]
    msg = b"finalexp-smoke" + b"\x00" * 18
    sig = bls.Sign(sum(sks) % O.R, msg)
    bad_msg = b"\xff" + msg[1:]
    out, lay, pre = bb._miller_fast_aggregate(
        [pks, pks], [msg, bad_msg], [sig, sig], dev)
    if out is None or not pre[:2].all():
        print("finalexp-smoke: Miller stage failed to produce f rows")
        return 2
    for i, tag in ((0, "real-valid"), (1, "real-corrupted")):
        r, ns = lay.split(i)
        f_coeffs = [fq.from_mont_limbs(out[f"{ns}f.{j}"][r])
                    for j in range(12)]
        f = bb._flat_ints_to_oracle(f_coeffs)
        unitary_cases.append((tag, easy(f)))
    adversarial_cases = [
        ("non-unitary-1", rand_fq12()),
        ("non-unitary-2", rand_fq12()),
    ]
    ONE_FLAT = [1] + [0] * 11

    # every routed variant except the long-standing bit-serial chain, from
    # the canonical map (a variant added to routing joins this canary)
    routed = {name: kind for name, kind in bb._HARD_PART_KINDS.items()
              if name != "bit_serial"}
    shape = dict(w_mul=bb.W_MUL, w_lin=bb.W_LIN,
                 pad_steps_to=bb.PAD_STEPS, pad_regs_to=bb._pow2(64))
    failures = []
    for vname, kind in routed.items():
        pr = vmlib.BUILDERS[kind](0, 1).assemble(annotate=False, **shape)

        def run(g):
            flat = bb._oracle_to_flat_ints(g)
            ins = {f"g.{i}": fq.to_mont_int(flat[i]) for i in range(12)}
            got = vm.execute(pr, ins, device=dev)
            return [fq.from_mont_limbs(got[f"res.{i}"]) for i in range(12)]

        try:
            for tag, g in unitary_cases:
                got = run(g)
                want = bb._oracle_to_flat_ints(oracle_res(g))
                if got != want:
                    failures.append(f"{vname}/{tag}: VM res != exact-int HHT")
                    continue
                if vname == "frobenius":
                    want2 = bb._oracle_to_flat_ints(oracle_res_frobenius(g))
                    if got != want2:
                        failures.append(
                            f"{vname}/{tag}: lambda-decomposition drift")
                want_verdict = bb._hard_part_is_one_oracle(
                    bb._oracle_to_flat_ints(g))
                if (got == ONE_FLAT) != want_verdict:
                    failures.append(f"{vname}/{tag}: verdict mismatch")
            for tag, g in adversarial_cases:
                got = run(g)
                if got == ONE_FLAT:
                    failures.append(
                        f"{vname}/{tag}: adversarial input accepted")
                if run(g) != got:
                    failures.append(f"{vname}/{tag}: nondeterministic output")
        except Exception as e:
            failures.append(f"{vname}: crashed: {type(e).__name__}: {e}")
            continue
        print(f"finalexp-smoke: {vname}: "
              f"{len(unitary_cases)} unitary + {len(adversarial_cases)} "
              f"adversarial cases checked on {dev.type}")

    if failures:
        for f_ in failures:
            print(f"finalexp-smoke FAIL: {f_}")
        path = flight.global_recorder().dump(reason="finalexp_smoke_failure")
        if path:
            print(f"finalexp-smoke: flight journal dumped to {path}")
        return 1
    print(f"finalexp-smoke: OK: {' + '.join(routed)} bit-identical to the "
          "exact-int oracle over valid and adversarial inputs")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(args[args.index("--device") + 1]
                  if "--device" in args else None))
