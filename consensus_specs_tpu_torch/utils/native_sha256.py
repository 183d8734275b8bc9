"""ctypes binding for the native batched SHA-256 (the port's copy of
consensus_specs_tpu/utils/native_sha256.py, over its own copy of the C
source, ``consensus_specs_tpu_torch/csrc/sha256_batch.c``).

``hash_pairs(data) -> bytes`` hashes ``len(data)//64`` independent 64-byte
messages in ONE native call: the merkleization inner loop
(utils/ssz/ssz_typing.py merkleize_chunks, merkle/levels.py) calls it once
per tree layer instead of once per node pair through hashlib.

``hash_many(messages) -> list[bytes]`` hashes a batch of VARIABLE-length
messages in one native call.

The shared object is built with the host C compiler on first use into the
package's ``_build/`` directory (gitignored, beside the CUDA kernels), named
by a hash of the source so an edited source is rebuilt. Everything uses
hashlib when no compiler exists: the digests are identical, so the native
path is a host throughput component, never a correctness dependency.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "sha256_batch.c"
BUILD_DIR = _PKG / "_build"

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libsha256_batch_{digest}.so"


def _compiler():
    return shutil.which("cc") or shutil.which("gcc")


def _build(so: Path) -> bool:
    """Compile to a temporary path, then os.replace onto the final name, so
    a library is never seen half written by another process."""
    cc = _compiler()
    if cc is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.%d.tmp" % os.getpid())
    try:
        subprocess.run(
            [cc, "-O3", "-fPIC", "-shared", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib) -> None:
    lib.sha256_hash_pairs.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.sha256_hash_pairs.restype = None
    lib.sha256_hash_many.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.sha256_hash_many.restype = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        so = library_path()
        if not so.exists() and not _build(so):
            _lib = False
            return _lib
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        _lib = lib
    except (OSError, AttributeError):
        _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def hash_pairs(data: bytes) -> bytes:
    """SHA-256 of each consecutive 64-byte message in ``data``; returns the
    concatenated 32-byte digests."""
    n, rem = divmod(len(data), 64)
    assert rem == 0, "hash_pairs input must be a whole number of 64-byte pairs"
    lib = _load()
    if not lib:
        out = bytearray()
        for i in range(n):
            out += hashlib.sha256(data[64 * i: 64 * (i + 1)]).digest()
        return bytes(out)
    buf = ctypes.create_string_buffer(32 * n)
    lib.sha256_hash_pairs(data, buf, n)
    return buf.raw


def hash_many(messages: Sequence[bytes]) -> List[bytes]:
    """SHA-256 of each (variable-length) message, one native call for the
    whole batch; hashlib when the library is not built."""
    n = len(messages)
    if n == 0:
        return []
    lib = _load()
    if not lib:
        return [hashlib.sha256(m).digest() for m in messages]
    lens = (ctypes.c_uint64 * n)(*[len(m) for m in messages])
    out = ctypes.create_string_buffer(32 * n)
    lib.sha256_hash_many(b"".join(messages), lens, out, n)
    raw = out.raw
    return [raw[32 * i : 32 * (i + 1)] for i in range(n)]
