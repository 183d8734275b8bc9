"""Memory-bounded pubkey plane of the port: batched decompression +
bytes-budgeted LRU (the counterpart of consensus_specs_tpu/scale/pubkeys.py).

A mainnet registry is ~1M compressed pubkeys; decompressed Montgomery
limb columns are ~13x larger, so "decompress everything once" is a
multi-GB resident set. This plane holds the DECOMPRESSED working set
under an explicit byte budget: committee misses go through the
``ops/codec.py`` batched G1 decompression (+ subgroup check) in one
batch on ``device`` (None is the CUDA card), land in an LRU ordered dict
accounted in bytes, and are mirrored into ``bls_backend._PK_CACHE`` so
the verify path's host prep finds every key warm. Eviction pops BOTH
sides — the budget is a real bound on decompressed-key memory, not a
suggestion.

Gauges (``scale.pubkey_*``): hits, misses, bytes, evictions, hit rate.
"""
import os
from collections import OrderedDict
from typing import List, Sequence, Tuple

BUDGET_ENV = "CONSENSUS_SPECS_TPU_SCALE_PK_BUDGET_MB"
_DEFAULT_BUDGET_MB = 256

# conservative per-entry overhead: dict slot + key bytes + tuple + two
# ndarray headers (the limb payload itself is counted exactly)
_ENTRY_OVERHEAD = 256


def default_budget_bytes() -> int:
    try:
        mb = float(os.environ.get(BUDGET_ENV, "") or _DEFAULT_BUDGET_MB)
    except ValueError:
        mb = _DEFAULT_BUDGET_MB
    return max(1, int(mb * (1 << 20)))


def rss_bytes() -> int:
    """Current resident set (linux: /proc/self/statm; 0 elsewhere)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, IndexError, ValueError):
        return 0


def peak_rss_bytes() -> int:
    """Process high-water-mark resident set (linux VmHWM; falls back to
    the current RSS where /proc/self/status is unavailable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, IndexError, ValueError):
        pass
    return rss_bytes()


class PubkeyPlane:
    """Bytes-budgeted LRU over decompressed G1 pubkeys.

    ``warm(pubkeys)`` batch-decompresses the misses through the codec
    vectorized path and returns (hits, misses) for the call. Entries
    are (x_limbs, y_limbs) Montgomery columns — the exact value
    ``bls_backend._PK_CACHE`` stores, which this plane keeps mirrored
    for every key it holds so the serve/verify host prep never pays a
    per-item decompression for a committee the plane warmed.
    """

    def __init__(self, budget_bytes: int = None, mirror_backend: bool = True,
                 device=None):
        self.budget_bytes = (default_budget_bytes()
                             if budget_bytes is None else int(budget_bytes))
        if self.budget_bytes <= 0:
            raise ValueError("pubkey-plane budget must be positive")
        self.mirror_backend = mirror_backend
        self.device = device
        self._lru: "OrderedDict[bytes, Tuple]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected = 0  # invalid encodings (never cached)

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, pubkey: bytes) -> bool:
        return bytes(pubkey) in self._lru

    @staticmethod
    def _entry_bytes(key: bytes, value) -> int:
        x, y = value
        return len(key) + int(x.nbytes) + int(y.nbytes) + _ENTRY_OVERHEAD

    def _backend_cache(self):
        from ..ops import bls_backend

        return bls_backend

    def _evict_to_budget(self) -> None:
        backend = self._backend_cache() if self.mirror_backend else None
        while self.bytes > self.budget_bytes and self._lru:
            key, value = self._lru.popitem(last=False)
            self.bytes -= self._entry_bytes(key, value)
            self.evictions += 1
            if backend is not None:
                backend._PK_CACHE.pop(key, None)

    def _insert(self, key: bytes, value) -> None:
        if key in self._lru:
            return
        self._lru[key] = value
        self.bytes += self._entry_bytes(key, value)
        if self.mirror_backend:
            backend = self._backend_cache()
            backend._cache_put(backend._PK_CACHE, key, value)
        self._evict_to_budget()

    def warm(self, pubkeys: Sequence[bytes]) -> Tuple[int, int]:
        """Ensure every (valid, deduplicated) key is decompressed and
        resident; misses pay ONE vectorized codec batch. Returns the
        (hits, misses) this call observed."""
        seen = set()
        order: List[bytes] = []
        for pk in pubkeys:
            pk = bytes(pk)
            if pk not in seen:
                seen.add(pk)
                order.append(pk)
        miss_keys: List[bytes] = []
        hits = 0
        for pk in order:
            value = self._lru.get(pk)
            if value is not None:
                self._lru.move_to_end(pk)  # refresh recency
                hits += 1
                if self.mirror_backend:
                    backend = self._backend_cache()
                    if pk not in backend._PK_CACHE:
                        backend._cache_put(backend._PK_CACHE, pk, value)
            else:
                miss_keys.append(pk)
        if miss_keys:
            from ..ops import codec

            values = codec.pubkey_limbs_batch(miss_keys, self.device)
            for pk, value in zip(miss_keys, values):
                if isinstance(value, ValueError):
                    self.rejected += 1
                    continue
                self._insert(pk, tuple(value))
        self.hits += hits
        self.misses += len(miss_keys)
        self._export_gauges()
        return hits, len(miss_keys)

    def get(self, pubkey: bytes):
        """Decompressed (x, y) limb columns, warming on miss."""
        pk = bytes(pubkey)
        value = self._lru.get(pk)
        if value is not None:
            self._lru.move_to_end(pk)
            self.hits += 1
            self._export_gauges()
            return value
        self.warm([pk])
        return self._lru.get(pk)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return (self.hits / total) if total else 0.0

    def _export_gauges(self) -> None:
        from ..ops import profiling

        profiling.set_gauge("scale.pubkey_cache_hits", float(self.hits))
        profiling.set_gauge("scale.pubkey_cache_misses", float(self.misses))
        profiling.set_gauge("scale.pubkey_cache_bytes", float(self.bytes))
        profiling.set_gauge("scale.pubkey_cache_evictions",
                            float(self.evictions))
        profiling.set_gauge("scale.pubkey_hit_rate", self.hit_rate())
