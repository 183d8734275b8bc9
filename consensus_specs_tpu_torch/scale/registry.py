"""Synthetic mainnet registry of the port: deterministic seed -> millions
of validators (the counterpart of consensus_specs_tpu/scale/registry.py,
bit-identical to it: the same identities, shuffling and aggregates).

The registry never materializes per-validator Python objects. Identity
is a pure function of (seed, index): the secret key is a small distinct
scalar derived from both, the pubkey is ``SkToPk`` of it (a REAL G1
point — every signature built from this registry verifies through the
real pairing planes), and committee membership comes from the spec's
swap-or-not shuffle at mainnet preset, computed for ALL indices at once
as columnar numpy (``shuffle_batch`` below is bit-identical to
``spec.compute_shuffled_index`` per element — pinned against the JAX
registry by tests/test_torch_scale.py).

Deriving a mainnet slot's pubkeys is ~26 s of host work in one process;
``committee_items`` and ``pubkeys`` take a ``utils.keygen.KeyPool`` to
spread it over spawned processes with the same bytes.

Why vectorize the shuffle instead of calling the spec per index: one
mainnet epoch permutation is N calls x SHUFFLE_ROUND_COUNT(90) rounds
x 2 hashes through typed uint wrappers — minutes of pure Python at
N=1M. Batched, each round is one pivot hash + ceil(N/256) source-block
hashes + a numpy gather: the full million-validator permutation takes
seconds and lives in one 8 MB uint64 column.
"""
import hashlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.keygen import KeyPool

DOMAIN_BEACON_ATTESTER = b"\x01\x00\x00\x00"

# mainnet-preset committee constants (phase0/beacon-chain.md); the
# registry tests cross-check them against build_spec_module("phase0",
# "mainnet") so drift in specsrc surfaces here
SLOTS_PER_EPOCH = 32
MAX_COMMITTEES_PER_SLOT = 64
TARGET_COMMITTEE_SIZE = 128
SHUFFLE_ROUND_COUNT = 90


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def shuffle_batch(n: int, seed: bytes, rounds: int = SHUFFLE_ROUND_COUNT
                  ) -> np.ndarray:
    """Forward swap-or-not map applied to every index at once:
    ``out[i] == compute_shuffled_index(i, n, seed)`` (bit-identical;
    beacon-chain.md:755-780). Per round the spec derives one pivot hash
    and a source byte per 256-position block — batched, that is
    ceil(n/256) hashes and one vectorized bit gather instead of n
    per-index recomputations."""
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    idx = np.arange(n, dtype=np.uint64)
    if n == 1:
        return idx
    big = np.uint64(n)
    n_blocks = (n + 255) // 256
    for r in range(rounds):
        rb = bytes([r])
        pivot = np.uint64(int.from_bytes(_sha(seed + rb)[:8], "little") % n)
        flip = (pivot + big - idx) % big
        position = np.maximum(idx, flip)
        blocks = b"".join(
            _sha(seed + rb + int(b).to_bytes(4, "little"))
            for b in range(n_blocks))
        bits = np.unpackbits(np.frombuffer(blocks, dtype=np.uint8),
                             bitorder="little")
        swap = bits[position.astype(np.int64)].astype(bool)
        idx = np.where(swap, flip, idx)
    return idx


def committee_count_per_slot(n_validators: int,
                             slots_per_epoch: int = SLOTS_PER_EPOCH,
                             max_committees: int = MAX_COMMITTEES_PER_SLOT,
                             target_size: int = TARGET_COMMITTEE_SIZE) -> int:
    """get_committee_count_per_slot over an all-active registry
    (beacon-chain.md:885-895)."""
    return max(1, min(max_committees,
                      n_validators // slots_per_epoch // target_size))


def attesters_per_slot(n_validators: int,
                       slots_per_epoch: int = SLOTS_PER_EPOCH) -> int:
    """Validators attesting in ONE slot when every registered validator
    is active: the full committee fan-out covers the registry once per
    epoch, so each slot touches n/SLOTS_PER_EPOCH of it. This is the
    real per-block state-delta size the merkle bench's incremental
    re-root model uses (mainnet shape: 1M validators -> 32768 touched
    per slot)."""
    return max(1, min(n_validators, n_validators // slots_per_epoch))


class Registry:
    """Deterministic synthetic registry of ``n_validators`` with real
    BLS identities and mainnet-preset committees.

    Holds O(n) COLUMNAR state only (one cached uint64 permutation per
    epoch) — never a per-validator Python object, list of pubkeys, or
    materialized epoch of committees. Pubkeys are derived on demand per
    touched committee; everything is a pure function of (seed, index).
    """

    def __init__(self, n_validators: int, seed: int = 7,
                 slots_per_epoch: int = SLOTS_PER_EPOCH,
                 max_committees: int = MAX_COMMITTEES_PER_SLOT,
                 target_size: int = TARGET_COMMITTEE_SIZE,
                 shuffle_rounds: int = SHUFFLE_ROUND_COUNT):
        if n_validators <= 0:
            raise ValueError("registry needs at least one validator")
        self.n_validators = int(n_validators)
        self.seed = int(seed)
        self.slots_per_epoch = int(slots_per_epoch)
        self.max_committees = int(max_committees)
        self.target_size = int(target_size)
        self.shuffle_rounds = int(shuffle_rounds)
        self._material = _sha(b"consensus-specs-tpu/scale/registry:"
                              + self.seed.to_bytes(8, "little"))
        # 16-bit seed salt below the index lane keeps secret keys
        # distinct across indices AND across seeds while staying small
        # (fast double-and-add SkToPk: ~0.8 ms/key vs ~10 ms for full
        # 255-bit scalars)
        self._sk_salt = int.from_bytes(self._material[:2], "little")
        self._perms: Dict[int, np.ndarray] = {}
        from ..ops import profiling

        profiling.set_gauge("scale.registry_validators",
                            float(self.n_validators))

    # -- identities ----------------------------------------------------------

    def secret_key(self, index: int) -> int:
        if not (0 <= index < self.n_validators):
            raise IndexError(f"validator index {index} out of range")
        return ((index + 1) << 16) | self._sk_salt

    def pubkey(self, index: int) -> bytes:
        from ..utils import bls

        return bls.SkToPk(self.secret_key(index))

    def pubkeys(self, indices, pool=None) -> List[bytes]:
        """Compressed pubkeys for a committee's index column, derived in
        ``pool`` (a ``utils.keygen.KeyPool``; by default one process, the
        switchboard's own ``SkToPk``)."""
        pool = pool or KeyPool(1)
        return pool.sk_to_pk([self.secret_key(int(i)) for i in indices])

    def iter_pubkeys(self, batch: int = 1024,
                     limit: Optional[int] = None
                     ) -> Iterator[Tuple[np.ndarray, List[bytes]]]:
        """Lazily emit (index column, compressed pubkeys) in bounded
        batches — the whole registry streams without ever existing as
        one list."""
        stop = self.n_validators if limit is None else min(
            limit, self.n_validators)
        for lo in range(0, stop, batch):
            hi = min(lo + batch, stop)
            idx = np.arange(lo, hi, dtype=np.uint64)
            yield idx, self.pubkeys(idx)

    def digest(self, sample: Optional[int] = None) -> str:
        """Streamed registry digest: sha256 over the header and the
        compressed pubkeys of either every validator (small registries,
        tests) or a deterministic evenly-spaced ``sample`` (the 1M
        bench — full derivation would be the one thing lazy emission
        exists to avoid)."""
        h = hashlib.sha256()
        h.update(b"scale-registry-digest")
        h.update(self.n_validators.to_bytes(8, "little"))
        h.update(self._material)
        if sample is None or sample >= self.n_validators:
            for _, pks in self.iter_pubkeys():
                for pk in pks:
                    h.update(pk)
        else:
            step = max(1, self.n_validators // max(1, sample))
            for index in range(0, self.n_validators, step):
                h.update(self.pubkey(index))
        return h.hexdigest()

    # -- committees ----------------------------------------------------------

    def committees_per_slot(self) -> int:
        return committee_count_per_slot(
            self.n_validators, self.slots_per_epoch,
            self.max_committees, self.target_size)

    def attester_seed(self, epoch: int) -> bytes:
        """Synthetic get_seed: domain + registry material + epoch. (No
        randao history in a synthetic registry; determinism per (seed,
        epoch) is what the workload needs.)"""
        return _sha(DOMAIN_BEACON_ATTESTER + self._material
                    + int(epoch).to_bytes(8, "little"))

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        perm = self._perms.get(epoch)
        if perm is None:
            perm = shuffle_batch(self.n_validators,
                                 self.attester_seed(epoch),
                                 self.shuffle_rounds)
            # one live epoch permutation: committees of slot s and s+1
            # share it, a new epoch evicts it (memory stays one column)
            self._perms.clear()
            self._perms[epoch] = perm
        return perm

    def committee(self, slot: int, index: int) -> np.ndarray:
        """Validator-index column of committee ``index`` at ``slot``
        (slices the epoch permutation exactly the way
        ``compute_committee`` + ``get_beacon_committee`` do)."""
        per_slot = self.committees_per_slot()
        if not (0 <= index < per_slot):
            raise IndexError(f"committee index {index} out of range")
        epoch = slot // self.slots_per_epoch
        count = per_slot * self.slots_per_epoch
        flat = (slot % self.slots_per_epoch) * per_slot + index
        n = self.n_validators
        start = (n * flat) // count
        end = (n * (flat + 1)) // count
        return self._epoch_perm(epoch)[start:end]

    def committees_at_slot(self, slot: int) -> List[np.ndarray]:
        return [self.committee(slot, ci)
                for ci in range(self.committees_per_slot())]

    # -- attestation aggregates ---------------------------------------------

    def attestation_message(self, slot: int, index: int) -> bytes:
        """Deterministic 32-byte signing root for (slot, committee)."""
        return _sha(b"scale-att" + self._material
                    + int(slot).to_bytes(8, "little")
                    + int(index).to_bytes(8, "little"))

    def aggregate_parts(self, slot: int, index: int,
                        participation: float = 1.0
                        ) -> Tuple[np.ndarray, int, bytes]:
        """(member index column, summed secret key, message) of one
        committee's aggregate: what ``aggregate`` signs."""
        from ..utils.bls12_381 import R

        members = self.committee(slot, index)
        keep = max(1, int(round(len(members) * participation)))
        members = members[:keep]
        sk = sum(self.secret_key(int(i)) for i in members) % R
        return members, sk, self.attestation_message(slot, index)

    def aggregate(self, slot: int, index: int,
                  participation: float = 1.0) -> Tuple[List[bytes],
                                                       bytes, bytes]:
        """(pubkeys, message, aggregate signature) for one committee's
        aggregate attestation. ``participation`` < 1 drops the TAIL of
        the committee from the cover (a censored/partial aggregate —
        still a VALID signature over the participating subset, which is
        exactly what censorship looks like on the wire). The aggregate
        signature is built as one sign by the summed secret key — the
        same group element as aggregating per-validator signatures."""
        from ..utils import bls

        members, sk, message = self.aggregate_parts(slot, index,
                                                    participation)
        signature = bls.Sign(sk, message)
        return self.pubkeys(members), message, signature
