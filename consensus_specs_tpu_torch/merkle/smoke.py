"""The Merkleization-plane canary of the port (the counterpart of
consensus_specs_tpu/merkle/smoke.py): ``main()``.

Bit-identity of the native batched path against the pure-python oracle
over every SSZ shape class the engine Merkleizes — basic vectors and
lists (length mix-ins included), bitfields, byte vectors/lists, nested
containers, composite series through the cross-element plane, dynamic
shapes that must FALL BACK, and far-from-full capacities whose roots are
mostly zero-subtree padding — plus a seeded random incremental-cache
invalidation sweep: random dirty sets, appends, and deep aliased
mutations re-rooted through the warm layer cache and demanded identical
to a from-scratch cold rebuild every round.

Every check appends a journal record; on failure the journal dumps to
``merkle_flight.jsonl`` in the working directory. Crypto-free and
device-free: no pairings, no spec build, no kernel. Exit 0 on pass, 1
with a diagnosis.
"""
import json
import random
import sys

JOURNAL_PATH = "merkle_flight.jsonl"
SEED = 20240818


def main() -> int:
    from . import levels as _levels
    from ..utils.ssz.ssz_typing import (
        Bitlist, Bitvector, ByteList, Bytes32, Bytes48, Container,
        List as SSZList, Vector, boolean, uint8, uint16, uint64, uint256,
    )

    journal = []
    failures = []

    class Checkpoint(Container):
        epoch: uint64
        root: Bytes32

    class Leaf(Container):
        pubkey: Bytes48
        withdrawal_credentials: Bytes32
        effective_balance: uint64
        slashed: boolean
        activation_eligibility_epoch: uint64
        activation_epoch: uint64
        exit_epoch: uint64
        withdrawable_epoch: uint64

    class Nested(Container):
        tag: uint16
        flags: Bitvector[21]
        checkpoint: Checkpoint
        words: Vector[uint64, 5]
        roots: Vector[Bytes32, 3]

    rng = random.Random(SEED)

    def rbytes(n):
        return bytes(rng.randrange(256) for _ in range(n))

    def leaf(i):
        return Leaf(
            pubkey=Bytes48(rbytes(48)),
            withdrawal_credentials=Bytes32(rbytes(32)),
            effective_balance=uint64(rng.randrange(2**40)),
            slashed=boolean(rng.randrange(2)),
            activation_eligibility_epoch=uint64(rng.randrange(2**20)),
            activation_epoch=uint64(rng.randrange(2**20)),
            exit_epoch=uint64(rng.randrange(2**20)),
            withdrawable_epoch=uint64(rng.randrange(2**20)),
        )

    def nested(i):
        return Nested(
            tag=uint16(i % 2**16),
            flags=Bitvector[21](*[bool(rng.randrange(2))
                                  for _ in range(21)]),
            checkpoint=Checkpoint(epoch=uint64(i), root=Bytes32(rbytes(32))),
            words=Vector[uint64, 5](*[uint64(rng.randrange(2**50))
                                      for _ in range(5)]),
            roots=Vector[Bytes32, 3](*[Bytes32(rbytes(32))
                                       for _ in range(3)]),
        )

    def check(name, view) -> bytes:
        """native root == python-oracle root on a fresh decode; returns
        the agreed root for reuse."""
        typ = type(view)
        with _levels.forced_mode("native"):
            nat = bytes(typ.decode_bytes(view.encode_bytes())
                        .hash_tree_root())
        with _levels.forced_mode("python"):
            ora = bytes(typ.decode_bytes(view.encode_bytes())
                        .hash_tree_root())
        ok = nat == ora
        journal.append({"check": name, "ok": ok,
                        "native": nat.hex(), "python": ora.hex()})
        if not ok:
            failures.append(f"{name}: native {nat.hex()[:16]}.. != "
                            f"python {ora.hex()[:16]}..")
        return nat

    # -- shape-class sweep ------------------------------------------------
    check("vector/basic", Vector[uint64, 13](*[uint64(i * 3 + 1)
                                               for i in range(13)]))
    check("vector/uint8", Vector[uint8, 100](*[uint8(i % 251)
                                               for i in range(100)]))
    check("vector/uint256", Vector[uint256, 3](*[uint256(2**200 + i)
                                                 for i in range(3)]))
    check("vector/composite", Vector[Checkpoint, 9](
        *[Checkpoint(epoch=uint64(i), root=Bytes32(rbytes(32)))
          for i in range(9)]))
    for n in (0, 1, 7, 8, 33, 1000):  # list lengths incl. mix-in edges
        check(f"list/uint64/n={n}",
              SSZList[uint64, 2**18](*[uint64(rng.randrange(2**60))
                                       for _ in range(n)]))
    check("list/composite/plane", SSZList[Leaf, 2**40](
        *[leaf(i) for i in range(300)]))
    check("list/composite/small-fallback", SSZList[Leaf, 2**40](
        *[leaf(i) for i in range(3)]))
    check("list/nested-containers", SSZList[Nested, 2**16](
        *[nested(i) for i in range(40)]))
    # dynamically-shaped elements: the plane MUST fall back, roots must
    # still match
    inner = SSZList[uint64, 64]
    check("list/dynamic-elements-fallback", SSZList[inner, 128](
        *[inner(*[uint64(j) for j in range(i % 5)]) for i in range(20)]))
    for n in (0, 1, 5, 8, 255, 256, 257):
        check(f"bitlist/n={n}",
              Bitlist[2**12](*[bool(rng.randrange(2)) for _ in range(n)]))
    check("bitvector/513", Bitvector[513](*[bool(rng.randrange(2))
                                            for _ in range(513)]))
    check("bytelist", ByteList[2**14](rbytes(777)))
    check("bytes48", Bytes48(rbytes(48)))
    # zero-subtree padding: tiny occupancy of a 2^32 capacity
    check("list/zero-padding", SSZList[Bytes32, 2**32](
        *[Bytes32(rbytes(32)) for _ in range(5)]))
    check("container/nested", nested(7))
    check("container/defaults", Nested())

    # -- incremental invalidation sweep ------------------------------------
    regs = SSZList[Leaf, 2**40](*[leaf(i) for i in range(300)])
    bal = SSZList[uint64, 2**40](*[uint64(32 * 10**9) for _ in range(300)])
    bits = Bitlist[2**12](*[bool(rng.randrange(2)) for _ in range(100)])
    with _levels.forced_mode("native"):
        regs.hash_tree_root(), bal.hash_tree_root(), bits.hash_tree_root()
    for rnd in range(8):
        # random dirty set: replacements, deep aliased mutations, appends
        for i in rng.sample(range(len(regs)), 12):
            regs[i] = leaf(1000 + rnd * 100 + i)
        for i in rng.sample(range(len(regs)), 12):
            regs[i].effective_balance = uint64(rng.randrange(2**40))
        regs.append(leaf(2000 + rnd))
        for i in rng.sample(range(len(bal)), 25):
            bal[i] = uint64(rng.randrange(2**40))
        bal.append(uint64(rnd))
        for i in rng.sample(range(len(bits)), 10):
            bits[i] = not bits[i]
        bits.append(bool(rnd % 2))
        for name, view in (("registry", regs), ("balances", bal),
                           ("bitlist", bits)):
            with _levels.forced_mode("native"):
                warm = bytes(view.hash_tree_root())  # incremental path
            with _levels.forced_mode("python"):
                cold = bytes(type(view).decode_bytes(view.encode_bytes())
                             .hash_tree_root())
            ok = warm == cold
            journal.append({"check": f"incremental/{name}/round={rnd}",
                            "ok": ok, "native": warm.hex(),
                            "python": cold.hex()})
            if not ok:
                failures.append(
                    f"incremental/{name}/round={rnd}: warm cache root "
                    f"{warm.hex()[:16]}.. != from-scratch {cold.hex()[:16]}..")

    counters = dict(_levels.counters)
    journal.append({"check": "counters", "ok": True, **counters})

    if failures:
        print("merkle-smoke FAIL:")
        for f in failures:
            print(f"  {f}")
        with open(JOURNAL_PATH, "w") as fh:
            for rec in journal:
                fh.write(json.dumps(rec) + "\n")
        print(f"merkle-smoke: journal dumped to {JOURNAL_PATH}")
        return 1

    n_checks = sum(1 for r in journal if "native" in r)
    print(
        f"merkle-smoke OK: {n_checks} bit-identity checks (shape sweep + "
        f"8-round seeded invalidation sweep), native mode "
        f"{'available' if _levels.plane_enabled() else 'ABSENT (python)'}: "
        f"{counters['native_levels']} native levels, "
        f"{counters['cache_hits']} cache hits, "
        f"{counters['dirty_nodes']} dirty nodes, "
        f"{counters['fallbacks']} fallbacks"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
