"""Minimal pure-Python Snappy RAW-format codec of the port (the
counterpart of consensus_specs_tpu/utils/snappy.py).

The reference compresses test-vector SSZ parts with `python-snappy` (a C
binding, reference gen_helpers/gen_base/gen_runner.py:14, 229-235). That
package isn't available here, so this module implements the raw Snappy
block format (github.com/google/snappy/blob/main/format_description.txt)
directly:

- ``compress`` emits a LITERALS-ONLY stream — a valid Snappy encoding any
  conformant decompressor accepts (compression is an encoder freedom, not a
  format requirement; SSZ vectors are small and mostly incompressible
  hashes anyway).
- ``decompress`` implements the full tag set (literals + 1/2/4-byte-offset
  copies) so vectors produced by other toolchains round-trip too.
"""


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def compress(data: bytes) -> bytes:
    data = bytes(data)
    out = bytearray(_uvarint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + (1 << 32) - 1]
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        elif n < (1 << 8):
            out.append(60 << 2)
            out += n.to_bytes(1, "little")
        elif n < (1 << 16):
            out.append(61 << 2)
            out += n.to_bytes(2, "little")
        elif n < (1 << 24):
            out.append(62 << 2)
            out += n.to_bytes(3, "little")
        else:
            out.append(63 << 2)
            out += n.to_bytes(4, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    data = bytes(data)
    # preamble: uncompressed length
    total = 0
    shift = 0
    pos = 0
    while True:
        b = data[pos]
        pos += 1
        total |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                n = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            n += 1
            out += data[pos : pos + n]
            pos += n
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("snappy: zero copy offset")
        # copies may overlap their own output (run-length behaviour)
        start = len(out) - offset
        if start < 0:
            raise ValueError("snappy: copy before stream start")
        for i in range(length):
            out.append(out[start + i])
    if len(out) != total:
        raise ValueError(f"snappy: length mismatch {len(out)} != {total}")
    return bytes(out)
