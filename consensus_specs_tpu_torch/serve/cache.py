"""Content-keyed result cache of the streaming verification service (the
port's copy of consensus_specs_tpu/serve/cache.py).

Gossip fans the same aggregate out through many peers, so a node sees
each committee aggregate several times a slot. The serve plane never
verifies the same (kind, pubkeys, message(s), signature) content twice:

- a COMPLETED verification parks its bool in this LRU, so a later
  identical submit resolves at once;
- an IN-FLIGHT verification is deduplicated one level up (service.py's
  pending table): later submitters share the first submitter's Future and
  the backend sees the item once.

Keys are sha256 digests of a length-framed encoding: committee contents
are attacker-influenced, and an ambiguous concatenation (two different
pubkey/message splits colliding) would be a forgery vector.
"""
import hashlib
from collections import OrderedDict
from typing import Optional


def check_key(kind: str, pubkeys, messages, signature: bytes) -> bytes:
    """Collision-resistant content key. ``messages`` is one bytes (the
    fast_aggregate shape) or a per-key list (the aggregate shape); the
    framing tags the two so they can never alias."""
    h = hashlib.sha256()
    h.update(kind.encode())
    h.update(len(pubkeys).to_bytes(4, "little"))
    for pk in pubkeys:
        h.update(len(pk).to_bytes(2, "little"))
        h.update(pk)
    if isinstance(messages, (bytes, bytearray)):
        h.update(b"M")
        h.update(len(messages).to_bytes(4, "little"))
        h.update(messages)
    else:
        h.update(b"L")
        h.update(len(messages).to_bytes(4, "little"))
        for m in messages:
            h.update(len(m).to_bytes(4, "little"))
            h.update(m)
    h.update(signature)
    return h.digest()


class ResultCache:
    """Bounded LRU of completed verification results (key -> bool).

    Not internally locked: the service serializes access under its own
    lock (hits happen on submit threads, fills on the worker thread)."""

    def __init__(self, capacity: int = 1 << 16):
        assert capacity > 0
        self._cap = capacity
        self._d: "OrderedDict[bytes, bool]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: bytes) -> Optional[bool]:
        """The cached bool, or None on miss (results are never None)."""
        try:
            v = self._d[key]
        except KeyError:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key: bytes, value: bool) -> None:
        self._d[key] = bool(value)
        self._d.move_to_end(key)
        while len(self._d) > self._cap:
            self._d.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
