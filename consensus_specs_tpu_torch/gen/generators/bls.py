"""`bls` test-vector generator of the port: the 7 IETF-BLS handler suites,
with every verify-family case CROSS-CHECKED between the pure-Python oracle
and the port's backend on the card, the reference's py_ecc-vs-milagro
dual-implementation pattern (the counterpart of
consensus_specs_tpu/gen/generators/bls.py; reference:
tests/generators/bls/main.py, cross-checks at :80, 108-114).

The expected verdicts come from the oracle: the run pins the switchboard
to it (and ``bls_active`` on) and restores both after. The check calls
``ops/bls_backend`` itself on the card (``device=None``, the default: the
run raises before any case without one) or on the CPU's plain steps
(``--device cpu``). A check that disagrees or raises fails its case: no
fallback, the case stays ``INCOMPLETE`` and the run exits 1.

CLI: ``python -m consensus_specs_tpu_torch.gen.generators.bls -o DIR [-f]
[-l preset ...] [-c] [--device cpu]``.
"""
import argparse
import sys

from ...device import resolve_device
from ...utils import bls
from ..gen_runner import run_generator
from ..gen_typing import TestCase, TestProvider

PRIVKEYS = [
    0x263DBD792F5B1BE47ED85F8938C0F29586AF0B3AC7B257FE09659B64F9C1BC47,
    0x47B8192D77BF871B62E87859D653922725724A5C031AFEABC60BCEF5FF665138,
    0x328388AFF0D4A5B7DC9205ABD374E7E98F3CD9F3418EDB4EAFDA5FB16473D216,
]
MESSAGES = [b"\x00" * 32, b"\x56" * 32, b"\xab" * 32]

Z1_PUBKEY = b"\xc0" + b"\x00" * 47
Z2_SIGNATURE = b"\xc0" + b"\x00" * 95


def _hex(b):
    return "0x" + bytes(b).hex()


def _card_check(kind, args, expected, device):
    """A verify-family case on the port's backend (the counterpart of the
    JAX generator's ``_tpu_check``)."""
    from ...ops import bls_backend

    fn = {"verify": bls_backend.verify,
          "fast_aggregate_verify": bls_backend.fast_aggregate_verify,
          "aggregate_verify": bls_backend.aggregate_verify}[kind]
    got = fn(*args, device=device)
    if got != expected:  # raised, not asserted: ``python -O`` keeps it
        raise AssertionError(
            f"card backend disagrees on {kind}: {got} != {expected}")


def _cases():
    """(handler, case name, data, check): ``check`` is None or the
    (kind, args, expected) the card must answer."""
    # sign
    for i, sk in enumerate(PRIVKEYS):
        for j, msg in enumerate(MESSAGES):
            sig = bls.Sign(sk, msg)
            yield "sign", f"sign_case_{i}_{j}", {
                "input": {"privkey": hex(sk), "message": _hex(msg)},
                "output": _hex(sig),
            }, None

    # verify (incl. wrong key / wrong message / malformed)
    sk, msg = PRIVKEYS[0], MESSAGES[0]
    pk = bls.SkToPk(sk)
    sig = bls.Sign(sk, msg)
    wrong_pk = bls.SkToPk(PRIVKEYS[1])
    verify_cases = [
        ("valid", pk, msg, sig, True),
        ("wrong_pubkey", wrong_pk, msg, sig, False),
        ("wrong_message", pk, MESSAGES[1], sig, False),
        ("infinity_pubkey", Z1_PUBKEY, msg, sig, False),
        ("infinity_signature", pk, msg, Z2_SIGNATURE, False),
        ("garbage_signature", pk, msg, b"\xff" * 96, False),
    ]
    for name, p, m, s, want in verify_cases:
        got = bls.Verify(p, m, s)
        assert got == want, name
        yield "verify", f"verify_{name}", {
            "input": {"pubkey": _hex(p), "message": _hex(m), "signature": _hex(s)},
            "output": want,
        }, ("verify", (p, m, s), want)

    # aggregate
    sigs = [bls.Sign(sk, MESSAGES[1]) for sk in PRIVKEYS]
    agg = bls.Aggregate(sigs)
    yield "aggregate", "aggregate_3_signatures", {
        "input": [_hex(s) for s in sigs],
        "output": _hex(agg),
    }, None

    # fast_aggregate_verify
    pks = [bls.SkToPk(sk) for sk in PRIVKEYS]
    fav_cases = [
        ("valid", pks, MESSAGES[1], agg, True),
        ("missing_signer", pks[:2], MESSAGES[1], agg, False),
        ("wrong_message", pks, MESSAGES[2], agg, False),
        ("empty_pubkeys", [], MESSAGES[1], agg, False),
        ("empty_pubkeys_infinity_sig", [], MESSAGES[1], Z2_SIGNATURE, False),
        ("infinity_pubkey_member", pks + [Z1_PUBKEY], MESSAGES[1], agg, False),
    ]
    for name, p, m, s, want in fav_cases:
        got = bls.FastAggregateVerify(p, m, s)
        assert got == want, name
        yield "fast_aggregate_verify", f"fast_aggregate_verify_{name}", {
            "input": {"pubkeys": [_hex(x) for x in p], "message": _hex(m),
                      "signature": _hex(s)},
            "output": want,
        }, ("fast_aggregate_verify", (p, m, s), want)

    # aggregate_verify
    per_msg_sigs = [bls.Sign(sk, m) for sk, m in zip(PRIVKEYS, MESSAGES)]
    agg_multi = bls.Aggregate(per_msg_sigs)
    av_cases = [
        ("valid", pks, MESSAGES, agg_multi, True),
        ("swapped_messages", pks, [MESSAGES[1], MESSAGES[0], MESSAGES[2]], agg_multi, False),
        ("length_mismatch", pks, MESSAGES[:2], agg_multi, False),
    ]
    for name, p, m, s, want in av_cases:
        got = bls.AggregateVerify(p, m, s)
        assert got == want, name
        yield "aggregate_verify", f"aggregate_verify_{name}", {
            "input": {"pubkeys": [_hex(x) for x in p],
                      "messages": [_hex(x) for x in m],
                      "signature": _hex(s)},
            "output": want,
        }, ("aggregate_verify", (p, m, s), want)

    # eth_aggregate_pubkeys (altair extension, reference specs/altair/bls.md:33-57)
    agg_pk = bls.AggregatePKs(pks)
    yield "eth_aggregate_pubkeys", "aggregate_pubkeys_3", {
        "input": [_hex(x) for x in pks],
        "output": _hex(agg_pk),
    }, None

    # eth_fast_aggregate_verify (accepts infinity sig for empty participation)
    from ...builder import build_spec_module

    spec = build_spec_module("altair", "minimal")
    efav_cases = [
        ("valid", pks, MESSAGES[1], agg, True),
        ("empty_infinity_sig", [], MESSAGES[1], Z2_SIGNATURE, True),
        ("empty_nonzero_sig", [], MESSAGES[1], agg, False),
    ]
    for name, p, m, s, want in efav_cases:
        got = spec.eth_fast_aggregate_verify(p, m, s)
        assert bool(got) == want, name
        yield "eth_fast_aggregate_verify", f"eth_fast_aggregate_verify_{name}", {
            "input": {"pubkeys": [_hex(x) for x in p], "message": _hex(m),
                      "signature": _hex(s)},
            "output": want,
        }, None


def make_cases(device=None):
    """The 29 cases; a verify-family case's function runs its card check
    on ``device`` before it returns its part."""
    for handler, case_name, data, check in _cases():
        def case_fn(data=data, check=check):
            if check is not None:
                _card_check(*check, device)
            return [("data", "data", data)]

        yield TestCase(
            fork_name="general",
            preset_name="general",
            runner_name="bls",
            handler_name=handler,
            suite_name="bls",
            case_name=case_name,
            case_fn=case_fn,
        )


def main(args=None, device=None) -> int:
    """Run the generator: ``device`` (or ``--device``) None is the card,
    and raises without one; "cpu" runs the checks on the plain steps."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    ns, rest = parser.parse_known_args(args)
    device = device if device is not None else ns.device
    resolve_device(device)
    saved = (bls._backend, bls.bls_active)

    def prepare():
        bls.use_py_ecc()
        bls.bls_active = True

    provider = TestProvider(prepare=prepare,
                            make_cases=lambda: make_cases(device))
    try:
        return run_generator("bls", [provider], args=rest)
    finally:
        bls._backend, bls.bls_active = saved


if __name__ == "__main__":
    sys.exit(main())
