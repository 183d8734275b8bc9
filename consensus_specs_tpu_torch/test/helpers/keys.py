"""Deterministic validator keypairs: privkey = index + 1.

(reference: tests/core/pyspec/eth2spec/test/helpers/keys.py:4-6 — 8,192 keys)

Pubkeys are derived lazily (a G1 scalar mult each) and cached, since the
pure-Python oracle pays ~ms per derivation and most tests touch < 300 keys.
"""
from ...utils import bls

KEY_COUNT = 8192

privkeys = [i + 1 for i in range(KEY_COUNT)]


class _LazyPubkeys:
    def __init__(self):
        self._cache = {}

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(KEY_COUNT))]
        i = int(i)
        if i not in self._cache:
            was_active = bls.bls_active
            bls.bls_active = True
            try:
                self._cache[i] = bls.SkToPk(privkeys[i])
            finally:
                bls.bls_active = was_active
        return self._cache[i]

    def __len__(self):
        return KEY_COUNT

    def __iter__(self):
        return (self[i] for i in range(KEY_COUNT))


pubkeys = _LazyPubkeys()
pubkey_to_privkey = None  # built on demand via build_pubkey_to_privkey()


def build_pubkey_to_privkey(upto=512):
    return {bytes(pubkeys[i]): privkeys[i] for i in range(upto)}
