"""SHA-256 hash primitive of the port (reference: tests/core/pyspec/eth2spec/utils/hash_function.py:1-9)."""
from hashlib import sha256 as _sha256
from typing import Union


def hash(x: Union[bytes, bytearray, memoryview]) -> bytes:
    return _sha256(x).digest()
