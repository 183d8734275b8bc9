"""Shared file-system helper for the obs exports (no deps, leaf module).

Every artifact the observability plane writes (Chrome traces, flight
JSONL journals) is written to a temporary file and renamed, so a reader
never sees a half-written file.
"""
import os


def atomic_write_text(path: str, body: str) -> str:
    """Write ``body`` to ``path`` atomically (tmp + rename); returns
    ``path``. A write failure removes its own ``<path>.<pid>.tmp``; only
    a hard kill mid-write can orphan one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as fh:
            fh.write(body)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path
