"""Per-program VM registry: what was assembled, what it cost, and whether
the port's ``.vm_cache_torch/`` disk cache answered (the counterpart of
consensus_specs_tpu/obs/programs.py).

``ops/bls_backend._program`` notes every program it resolves (once per
(kind, k, fold) a process: its lru_cache absorbs the rest), keyed
``kind[k=...,fold=...]``. The registry rides the Chrome trace export
(top-level ``programRegistry`` key), and the ``bls.vm_cache_hits`` /
``bls.vm_cache_misses`` gauges ride ``profiling.summary()``: a cold cache
shows as a burst of misses with seconds-scale ``assembly_s``.
"""
import threading
from typing import Dict

_lock = threading.Lock()
PROGRAMS: Dict[str, Dict] = {}
CACHE_STATS = {"disk_hits": 0, "disk_misses": 0}


def note_assembly(key: str, *, n_steps: int, n_regs: int, seconds: float,
                  disk_cache_hit: bool) -> None:
    """Record one resolved program (disk-cache load OR fresh assembly;
    ``seconds`` is whichever path was paid)."""
    with _lock:
        CACHE_STATS["disk_hits" if disk_cache_hit else "disk_misses"] += 1
        PROGRAMS[key] = {
            "steps": int(n_steps),
            "regs": int(n_regs),
            "assembly_s": round(float(seconds), 4),
            "vm_cache": "hit" if disk_cache_hit else "miss",
        }
    export_gauges()


def export_gauges() -> None:
    """(Re-)publish the vm-cache gauges into profiling: ``profiling.reset()``
    clears gauges while note_assembly fires once per (kind, k, fold) a
    process, so a run that resets calls this after the reset."""
    with _lock:
        hits, misses = CACHE_STATS["disk_hits"], CACHE_STATS["disk_misses"]
    if hits or misses:
        from ..ops import profiling

        profiling.set_gauge("bls.vm_cache_hits", hits)
        profiling.set_gauge("bls.vm_cache_misses", misses)


def registry_snapshot() -> Dict:
    with _lock:
        return {
            "programs": {k: dict(v) for k, v in sorted(PROGRAMS.items())},
            "vm_cache": dict(CACHE_STATS),
        }


def reset() -> None:
    with _lock:
        PROGRAMS.clear()
        for k in CACHE_STATS:
            CACHE_STATS[k] = 0
