"""Incremental Merkle layer cache with batched dirty-set updates.

``LevelTree`` is the storage behind every SSZ series cache
(``ssz_typing._ChunkTree`` is an alias): the PRESENT nodes of each level
of a virtual zero-padded tree of fixed depth, built level-batched
through ``merkle/levels.py`` (one native ``sha256_hash_many`` call per
level) and updated through ``update()`` — a whole dirty CHUNK SET plus
appends propagate level by level, re-hashing only the touched parent
frontier, and each level's touched pairs go through one batched hash
call instead of a hashlib round trip per dirty path node. A block's
state delta therefore costs O(log N · changed) node recomputes
(``merkle.dirty_nodes``) across at most ``depth`` hash calls.

Layout contract (shared with ``utils/ssz/proofs.py`` which reads
``layers`` directly, and ``utils/merkle_minimal.py``): ``layers[d]`` is
the list of present nodes at height ``d`` above the chunks; absent right
siblings are the zero-subtree hashes of their height; ``root()`` folds
the top present node with zero hashes up to ``depth``. Bit-identical to
``merkleize_chunks`` (cross-checked in tests/test_ssz_incremental.py and
the merkle smoke).
"""
from typing import Dict, Optional, Sequence

from . import levels as _levels
from .levels import ZERO_HASHES


class LevelTree:
    """Merkle layer cache over a virtual zero-padded tree of fixed depth.

    Stores only the present nodes of each layer, so a List[_, 2^40] with
    n chunks costs ~2n nodes. `set_chunk`/`append` update one chunk;
    `update` applies a whole dirty set + appends with per-level batched
    hashing; `root()` folds the top present node with zero hashes up to
    the type's depth."""

    __slots__ = ("depth", "layers")

    def __init__(self, depth: int, chunks: Sequence[bytes]):
        self.depth = depth
        self.layers = [list(chunks)]
        self._build_above(0)

    def _build_above(self, level: int) -> None:
        del self.layers[level + 1 :]
        cur = self.layers[level]
        lv = level
        while len(cur) > 1:
            cur = _levels.hash_level(cur, lv)
            self.layers.append(cur)
            lv += 1

    def n_chunks(self) -> int:
        return len(self.layers[0])

    def set_chunk(self, i: int, chunk: bytes) -> None:
        self.update({i: chunk})

    def append(self, chunk: bytes) -> None:
        self.update(None, (chunk,))

    def update(
        self,
        updates: Optional[Dict[int, bytes]] = None,
        appends: Optional[Sequence[bytes]] = None,
    ) -> None:
        """Write ``updates`` (chunk index -> new chunk) and ``appends``
        (new chunks past the current width), then re-hash the touched
        parent frontier level by level — each level one batched call."""
        base = self.layers[0]
        dirty = set()
        if updates:
            for i, c in updates.items():
                base[i] = c
                dirty.add(i >> 1)
        if appends:
            start = len(base)
            base.extend(appends)
            # parents of the appended range, plus the boundary pair the
            # last old chunk now shares with the first appended one
            dirty.update(range(start >> 1, (len(base) + 1) >> 1))
        if not dirty:
            return
        for lv in range(len(self.layers) - 1):
            cur = self.layers[lv]
            up = self.layers[lv + 1]
            parents = sorted(dirty)
            blob = bytearray()
            zh = ZERO_HASHES[lv]
            for pi in parents:
                blob += cur[2 * pi]
                blob += cur[2 * pi + 1] if 2 * pi + 1 < len(cur) else zh
            digests = _levels.hash_pair_blob(bytes(blob))
            _levels.counters["dirty_nodes"] += len(parents)
            dirty = set()
            for k, pi in enumerate(parents):
                h = digests[k << 5 : (k + 1) << 5]
                if pi == len(up):
                    up.append(h)
                else:
                    up[pi] = h
                dirty.add(pi >> 1)
        # growth past a power-of-two boundary needs new top layers
        while len(self.layers[-1]) > 1:
            self._build_above(len(self.layers) - 1)

    def root(self) -> bytes:
        if not self.layers[0]:
            return ZERO_HASHES[self.depth]
        node = self.layers[-1][0]
        for lv in range(len(self.layers) - 1, self.depth):
            node = _levels.hash_level([node, ZERO_HASHES[lv]], lv)[0]
        return node
