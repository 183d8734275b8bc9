"""Level-batched SSZ hashing core + the Merkleization mode knob.

This module is the bottom of the merkle plane: every caller
that hashes a tree LEVEL — ``merkleize_chunks``, the incremental layer
cache (``merkle/cache.py``), the cross-element cold-build plane
(``merkle/plane.py``) — routes the whole level through ONE
native ``sha256_hash_pairs`` call (the port's csrc/sha256_batch.c) instead of a
hashlib round trip per node pair.

The mode knob (``CONSENSUS_SPECS_TPU_MERKLE``):

- ``auto``   (default) — native batching wherever the shared library is
  available, byte-identical to the python path by construction.
- ``native`` — demand the native path; a missing library still falls
  back to hashlib per call but counts ``merkle.fallbacks`` so the bench
  gate can see the degradation.
- ``python`` — the pure-hashlib differential oracle: no native calls, no
  cross-element plane. ``CONSENSUS_SPECS_TPU_MERKLE_DIFF=1`` makes the
  SSZ facade (``utils/ssz/ssz_impl.hash_tree_root``) re-derive every
  root through this path on a fresh decode and assert bit-identity.

Import cost is stdlib + the lazy native loader only: ``ssz_typing``
imports this module at its own import time, so nothing here may import
the SSZ engine or the obs plane eagerly (profiling/latency are
reached lazily from ``export_gauges``/``note_root_seconds``).
"""
import contextlib
import hashlib
import os
from typing import Dict, List, Optional, Sequence

MODE_ENV = "CONSENSUS_SPECS_TPU_MERKLE"
DIFF_ENV = "CONSENSUS_SPECS_TPU_MERKLE_DIFF"

# below this many pairs the ctypes call gate + buffer join costs more
# than hashlib; same threshold the pre-plane merkleize_chunks used
MIN_NATIVE_PAIRS = 8

# zero-subtree table: ZERO_HASHES[k] is the root of 2^k zero chunks.
# Recomputed locally (sha256 is deterministic) so this module never
# imports ssz_typing — ssz_typing imports US.
ZERO_HASHES: List[bytes] = [b"\x00" * 32]
for _ in range(64):
    ZERO_HASHES.append(hashlib.sha256(ZERO_HASHES[-1] * 2).digest())

# plane counters, exported as the merkle.* gauge family (obs/registry.py)
counters: Dict[str, int] = {
    "native_levels": 0,   # levels hashed through one native call
    "cache_hits": 0,      # series re-roots served from a warm layer tree
    "dirty_nodes": 0,     # nodes recomputed by batched dirty-set updates
    "fallbacks": 0,       # native demanded/planned but python path used
}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


# ---------------------------------------------------------------------------
# mode resolution
# ---------------------------------------------------------------------------

_forced: List[str] = []         # forced_mode() stack (benches, diff oracle)
_configured: Optional[str] = None  # configure() override (None = read env)
_native_fn = None               # resolved native hash_pairs, or False
_VALID_MODES = ("native", "python", "auto")


def _native():
    """The native pair hasher, resolved once; ``None`` if unavailable."""
    global _native_fn
    if _native_fn is None:
        try:
            from ..utils.native_sha256 import available, hash_pairs

            _native_fn = hash_pairs if available() else False
        except Exception:
            _native_fn = False
    return _native_fn or None


def configure(mode: Optional[str] = None) -> None:
    """Pin the mode programmatically; ``configure(None)`` re-reads the env
    on the next call (tests and benches flip modes without env games)."""
    global _configured
    if mode is not None and mode not in _VALID_MODES:
        raise ValueError(f"{MODE_ENV} mode {mode!r} not in {_VALID_MODES}")
    _configured = mode


@contextlib.contextmanager
def forced_mode(mode: str):
    """Scoped mode override — the differential oracle and the bench's
    python-baseline passes run under ``forced_mode("python")``."""
    if mode not in _VALID_MODES:
        raise ValueError(f"{MODE_ENV} mode {mode!r} not in {_VALID_MODES}")
    _forced.append(mode)
    try:
        yield
    finally:
        _forced.pop()


def requested_mode() -> str:
    """The knob as set (native|python|auto), before availability."""
    if _forced:
        return _forced[-1]
    if _configured is not None:
        return _configured
    m = os.environ.get(MODE_ENV, "auto").strip().lower() or "auto"
    return m if m in _VALID_MODES else "auto"


def mode() -> str:
    """The RESOLVED mode: what the hash path will actually do."""
    m = requested_mode()
    if m == "auto":
        return "native" if _native() is not None else "python"
    return m


def use_native() -> bool:
    """True when level calls should try the native path. In ``native``
    mode with the library missing this stays True so the per-call
    fallback is visible in ``merkle.fallbacks``."""
    return requested_mode() != "python" and (
        requested_mode() == "native" or _native() is not None
    )


def plane_enabled() -> bool:
    """Whether the cross-element cold-build plane may run: never in
    python mode (the oracle must be the plain per-element walk), and
    only when the native library is really present (batching through
    hashlib would just move the python loop around)."""
    return requested_mode() != "python" and _native() is not None


def diff_enabled() -> bool:
    return os.environ.get(DIFF_ENV) == "1"


# ---------------------------------------------------------------------------
# the level hashers
# ---------------------------------------------------------------------------


def hash_pair_blob(blob: bytes) -> bytes:
    """Hash a contiguous buffer of 64-byte messages into the concatenated
    32-byte digests — the primitive every batched level reduces through."""
    n_pairs = len(blob) >> 6
    if n_pairs >= MIN_NATIVE_PAIRS and use_native():
        fn = _native()
        if fn is not None:
            counters["native_levels"] += 1
            return fn(blob)
        counters["fallbacks"] += 1
    sha = hashlib.sha256
    return b"".join(
        sha(blob[i << 6 : (i + 1) << 6]).digest() for i in range(n_pairs)
    )


def hash_level(level: Sequence[bytes], depth: int) -> List[bytes]:
    """Hash one tree level into its parents; an odd tail pairs with the
    zero-subtree hash of ``depth`` (the canonical sparse-padding rule)."""
    n = len(level)
    if n % 2:
        level = list(level)
        level.append(ZERO_HASHES[depth])
        n += 1
    n_pairs = n >> 1
    if n_pairs >= MIN_NATIVE_PAIRS and use_native():
        fn = _native()
        if fn is not None:
            counters["native_levels"] += 1
            digests = fn(b"".join(level))
            return [digests[i << 5 : (i + 1) << 5] for i in range(n_pairs)]
        counters["fallbacks"] += 1
    sha = hashlib.sha256
    return [
        sha(level[2 * i] + level[2 * i + 1]).digest() for i in range(n_pairs)
    ]


def build_levels(chunks: Sequence[bytes]) -> List[List[bytes]]:
    """All levels from ``chunks`` up to a single present node (the stored
    half of a virtual zero-padded tree; see ``merkle/cache.py``)."""
    levels = [list(chunks)]
    lv = 0
    while len(levels[-1]) > 1:
        levels.append(hash_level(levels[-1], lv))
        lv += 1
    return levels


# ---------------------------------------------------------------------------
# obs surface (lazy: nothing above imports the obs/ops planes)
# ---------------------------------------------------------------------------


def export_gauges() -> None:
    """Publish the counters as the ``merkle.*`` gauge family."""
    from ..ops import profiling

    profiling.set_gauge("merkle.native_levels", float(counters["native_levels"]))
    profiling.set_gauge("merkle.cache_hits", float(counters["cache_hits"]))
    profiling.set_gauge("merkle.dirty_nodes", float(counters["dirty_nodes"]))
    profiling.set_gauge("merkle.fallbacks", float(counters["fallbacks"]))


def note_root_seconds(seconds: float) -> None:
    """One facade-level ``hash_tree_root`` observation into the
    ``latency[merkle_root]`` stage histogram; never raises (the facade
    must stay usable before/without the obs plane)."""
    try:
        from ..obs import latency

        latency.note_stage("merkle_root", seconds)
    except Exception:
        pass
