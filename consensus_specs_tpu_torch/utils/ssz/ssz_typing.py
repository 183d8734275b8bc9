"""SSZ type algebra + merkleization engine (the port's copy of
consensus_specs_tpu/utils/ssz/ssz_typing.py).

Ground-up replacement for the reference's external `remerkleable` dependency
(reference: tests/core/pyspec/eth2spec/utils/ssz/ssz_typing.py:4-13 re-exports;
semantics per the reference's ssz/simple-serialize.md:105-249).

Types: uintN, boolean, Container, Vector[T, N], List[T, N], Bitvector[N],
Bitlist[N], ByteVector[N] (Bytes1/4/20/32/48/96...), ByteList[N], Union.

Semantics notes (match remerkleable-backed reference behavior):
- uintN arithmetic returns the same type and raises on over/underflow
  (spec safety property, reference specs/phase0/beacon-chain.md:1236 note).
- Assigning a composite value INTO a container/list stores a deep copy
  (snapshot semantics, like remerkleable's persistent backing), while reads
  alias, so `state.validators[i].exit_epoch = e` mutates the state.

INCREMENTAL MERKLEIZATION (remerkleable's role, reference
utils/ssz/ssz_impl.py:12-13; SURVEY §7.3 hard part #6): Vector/List/Bitlist
keep a cached Merkle layer tree (`_ChunkTree`) plus per-element root/tag
caches, so `hash_tree_root` after k mutations re-hashes O(k log n) instead
of O(n). Mutation detection:
- every mutable view carries `_mut`, a GLOBALLY-UNIQUE monotonically
  assigned stamp refreshed by each mutator (unique values make the check
  robust against element replacement);
- direct mutations (series `__setitem__`/`append`) mark dirty indices;
- deep mutations through read aliases (`state.validators[i].slashed = x`)
  are caught by comparing each element's `_mut` stamp against the stamp
  recorded at the previous hash — an O(n) scan that re-HASHES only changes.
Stores snapshot (deep-copy) values, so every composite has exactly one
owner and local caches can never alias-skew. `copy.deepcopy` carries the
caches over (bytes are shared, structure is copied), keeping genesis-state
caches warm across per-test copies (reference test/context.py:83-104 relies
on the same property via remerkleable's structural sharing).
"""
from __future__ import annotations

import io
import itertools
from hashlib import sha256
from typing import Any, Dict, Optional, Sequence, Tuple, Type

from ...merkle import levels as _merkle_levels
from ...merkle.cache import LevelTree

# the cross-element cold-build plane imports THIS module back, so it can
# only be reached lazily (resolved on the first cold composite build)
_merkle_plane = None


def _get_merkle_plane():
    global _merkle_plane
    if _merkle_plane is None:
        from ...merkle import plane

        _merkle_plane = plane
    return _merkle_plane


_MUT_COUNTER = itertools.count(1)


def _bump(obj) -> None:
    """Stamp a mutable view with a fresh globally-unique mutation id."""
    object.__setattr__(obj, "_mut", next(_MUT_COUNTER))

BYTES_PER_CHUNK = 32
BITS_PER_BYTE = 8

# ---------------------------------------------------------------------------
# zero-hash table + merkleize core (reference: utils/merkle_minimal.py:7-89)
# ---------------------------------------------------------------------------

# one shared zero-subtree table (the merkle plane owns it: levels.py is
# import-cycle-free and every plane layer reads the same list object)
ZERO_HASHES = _merkle_levels.ZERO_HASHES


def next_power_of_two(v: int) -> int:
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def merkleize_chunks(chunks: Sequence[bytes], limit: Optional[int] = None) -> bytes:
    """Merkleize 32-byte chunks, padding with zero-chunks up to next_pow2(limit or count).
    Each level hashes through the merkle plane's batched level hasher
    (one native sha256_hash_many call per level when the
    CONSENSUS_SPECS_TPU_MERKLE mode allows and the level is wide enough)."""
    count = len(chunks)
    if limit is None:
        limit = count
    if count > limit:
        raise ValueError(f"merkleize: {count} chunks exceeds limit {limit}")
    width = next_power_of_two(limit)
    depth = (width - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]
    layer = list(chunks)
    for level in range(depth):
        layer = _merkle_levels.hash_level(layer, level)
    return layer[0]


# the incremental layer cache lives in the merkle plane now; the engine
# keeps its historical name (proofs.py and the incremental tests read
# `_ChunkTree` and its `layers` directly)
_ChunkTree = LevelTree


def _type_depth(limit: int) -> int:
    width = next_power_of_two(limit)
    return (width - 1).bit_length()


def mix_in_length(root: bytes, length: int) -> bytes:
    return sha256(root + length.to_bytes(32, "little")).digest()


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return sha256(root + selector.to_bytes(32, "little")).digest()


def pack_bytes_into_chunks(data: bytes) -> Tuple[bytes, ...]:
    if len(data) == 0:
        return ()
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return tuple(data[i : i + 32] for i in range(0, len(data), 32))


# ---------------------------------------------------------------------------
# base View
# ---------------------------------------------------------------------------


class View:
    """Base of all SSZ values."""

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def type_byte_length(cls) -> int:
        raise NotImplementedError  # only for fixed-size types

    @classmethod
    def default(cls) -> "View":
        return cls()

    @classmethod
    def coerce_view(cls, value: Any) -> "View":
        if isinstance(value, cls):
            return value
        return cls(value)

    def encode_bytes(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def decode_bytes(cls, data: bytes) -> "View":
        raise NotImplementedError

    def hash_tree_root(self) -> bytes:
        raise NotImplementedError

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)


def is_fixed_size(typ: Type[View]) -> bool:
    return typ.is_fixed_byte_length()


# ---------------------------------------------------------------------------
# basic types
# ---------------------------------------------------------------------------


class uint(int, View):
    TYPE_BYTE_LENGTH = 0

    def __new__(cls, value: int = 0):
        if isinstance(value, bytes):
            raise ValueError("uint from bytes not allowed; use decode_bytes")
        v = int(value)
        if v < 0 or v >= (1 << (cls.TYPE_BYTE_LENGTH * 8)):
            raise ValueError(f"{cls.__name__} out of range: {v}")
        return super().__new__(cls, v)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.TYPE_BYTE_LENGTH

    def encode_bytes(self) -> bytes:
        return int(self).to_bytes(self.TYPE_BYTE_LENGTH, "little")

    @classmethod
    def decode_bytes(cls, data: bytes) -> "uint":
        if len(data) != cls.TYPE_BYTE_LENGTH:
            raise ValueError(f"{cls.__name__}: wrong byte length {len(data)}")
        return cls(int.from_bytes(data, "little"))

    def hash_tree_root(self) -> bytes:
        return self.encode_bytes().ljust(32, b"\x00")

    # checked arithmetic: result stays in-type, raises on out-of-range;
    # non-int operands defer (NotImplemented) so e.g. list * uint64 repeats
    def _wrap(self, v: int) -> "uint":
        return type(self)(v)

    def __add__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) + int(o))

    def __radd__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(o) + int(self))

    def __sub__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) - int(o))

    def __rsub__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(o) - int(self))

    def __mul__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) * int(o))

    def __rmul__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(o) * int(self))

    def __floordiv__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) // int(o))

    def __rfloordiv__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(o) // int(self))

    def __mod__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) % int(o))

    def __rmod__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(o) % int(self))

    def __pow__(self, o, mod=None):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(pow(int(self), int(o), mod))

    def __lshift__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) << int(o))

    def __rshift__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) >> int(o))

    def __and__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) & int(o))

    def __or__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) | int(o))

    def __xor__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return self._wrap(int(self) ^ int(o))

    def __neg__(self):
        return self._wrap(-int(self))

    def __hash__(self):
        return int.__hash__(self)

    def __repr__(self):
        return f"{type(self).__name__}({int(self)})"


class uint8(uint):
    TYPE_BYTE_LENGTH = 1


class uint16(uint):
    TYPE_BYTE_LENGTH = 2


class uint32(uint):
    TYPE_BYTE_LENGTH = 4


class uint64(uint):
    TYPE_BYTE_LENGTH = 8


class uint128(uint):
    TYPE_BYTE_LENGTH = 16


class uint256(uint):
    TYPE_BYTE_LENGTH = 32


byte = uint8


class boolean(int, View):
    def __new__(cls, value: int = 0):
        v = int(value)
        if v not in (0, 1):
            raise ValueError(f"boolean out of range: {v}")
        return super().__new__(cls, v)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return 1

    def encode_bytes(self) -> bytes:
        return bytes([int(self)])

    @classmethod
    def decode_bytes(cls, data: bytes) -> "boolean":
        if len(data) != 1 or data[0] not in (0, 1):
            raise ValueError(f"boolean: invalid encoding {data!r}")
        return cls(data[0])

    def hash_tree_root(self) -> bytes:
        return self.encode_bytes().ljust(32, b"\x00")

    def __repr__(self):
        return f"boolean({int(self)})"

    def __hash__(self):
        return int.__hash__(self)


def is_basic_type(typ: Type[View]) -> bool:
    return isinstance(typ, type) and issubclass(typ, (uint, boolean))


# ---------------------------------------------------------------------------
# byte vectors / byte lists
# ---------------------------------------------------------------------------

_byte_vector_cache: Dict[int, type] = {}
_byte_list_cache: Dict[int, type] = {}


class ByteVector(bytes, View):
    LENGTH = 0

    def __class_getitem__(cls, length: int) -> type:
        if length not in _byte_vector_cache:
            _byte_vector_cache[length] = type(
                f"ByteVector[{length}]", (ByteVector,), {"LENGTH": length}
            )
        return _byte_vector_cache[length]

    def __new__(cls, value: bytes = None):
        if cls.LENGTH == 0 and cls is ByteVector:
            raise TypeError("raw ByteVector is not instantiable; parameterize it")
        if value is None:
            value = b"\x00" * cls.LENGTH
        if isinstance(value, str):
            if value.startswith("0x"):
                value = bytes.fromhex(value[2:])
            else:
                value = bytes.fromhex(value)
        value = bytes(value)
        if len(value) != cls.LENGTH:
            raise ValueError(f"{cls.__name__}: expected {cls.LENGTH} bytes, got {len(value)}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.LENGTH

    def encode_bytes(self) -> bytes:
        return bytes(self)

    @classmethod
    def decode_bytes(cls, data: bytes) -> "ByteVector":
        return cls(data)

    def hash_tree_root(self) -> bytes:
        return merkleize_chunks(pack_bytes_into_chunks(bytes(self)), limit=chunk_count(type(self)))

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


class ByteList(bytes, View):
    LIMIT = 0

    def __class_getitem__(cls, limit: int) -> type:
        if limit not in _byte_list_cache:
            _byte_list_cache[limit] = type(f"ByteList[{limit}]", (ByteList,), {"LIMIT": limit})
        return _byte_list_cache[limit]

    def __new__(cls, value: bytes = b""):
        if isinstance(value, str) and value.startswith("0x"):
            value = bytes.fromhex(value[2:])
        value = bytes(value)
        if len(value) > cls.LIMIT:
            raise ValueError(f"{cls.__name__}: {len(value)} bytes exceeds limit {cls.LIMIT}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    def encode_bytes(self) -> bytes:
        return bytes(self)

    @classmethod
    def decode_bytes(cls, data: bytes) -> "ByteList":
        return cls(data)

    def hash_tree_root(self) -> bytes:
        root = merkleize_chunks(
            pack_bytes_into_chunks(bytes(self)), limit=(self.LIMIT + 31) // 32
        )
        return mix_in_length(root, len(self))

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


# common aliases (reference: utils/ssz/ssz_typing.py + spec custom types)
Bytes1 = ByteVector[1]
Bytes4 = ByteVector[4]
Bytes8 = ByteVector[8]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


# ---------------------------------------------------------------------------
# bitfields
# ---------------------------------------------------------------------------

_bitvector_cache: Dict[int, type] = {}
_bitlist_cache: Dict[int, type] = {}


def _bits_to_bytes(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


class Bitvector(View):
    LENGTH = 0

    def __class_getitem__(cls, length: int) -> type:
        if length not in _bitvector_cache:
            _bitvector_cache[length] = type(
                f"Bitvector[{length}]", (Bitvector,), {"LENGTH": length}
            )
        return _bitvector_cache[length]

    def __init__(self, *args):
        if self.LENGTH == 0 and type(self) is Bitvector:
            raise TypeError("raw Bitvector is not instantiable; parameterize it")
        if len(args) == 1 and isinstance(args[0], (list, tuple, Bitvector)):
            bits = [bool(b) for b in args[0]]
        else:
            bits = [bool(b) for b in args]
        if len(bits) == 0:
            bits = [False] * self.LENGTH
        if len(bits) != self.LENGTH:
            raise ValueError(f"{type(self).__name__}: expected {self.LENGTH} bits, got {len(bits)}")
        self._bits = bits

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return (cls.LENGTH + 7) // 8

    def __len__(self):
        return self.LENGTH

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._bits[i]
        return self._bits[i]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            new_bits = list(self._bits)
            new_bits[i] = [bool(b) for b in v]
            if len(new_bits) != self.LENGTH:
                raise ValueError(f"{type(self).__name__}: slice assignment changes length")
            self._bits = new_bits
        else:
            self._bits[i] = bool(v)
        _bump(self)

    def __iter__(self):
        return iter(self._bits)

    def __eq__(self, other):
        if isinstance(other, Bitvector):
            return self.LENGTH == other.LENGTH and self._bits == other._bits
        if isinstance(other, (list, tuple)):
            return self._bits == [bool(b) for b in other]
        return NotImplemented

    def __hash__(self):
        return hash((self.LENGTH, tuple(self._bits)))

    def encode_bytes(self) -> bytes:
        return _bits_to_bytes(self._bits)

    @classmethod
    def decode_bytes(cls, data: bytes) -> "Bitvector":
        if len(data) != cls.type_byte_length():
            raise ValueError(f"{cls.__name__}: wrong byte length {len(data)}")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(cls.LENGTH)]
        # check padding bits are zero
        if cls.LENGTH % 8 != 0:
            if data[-1] >> (cls.LENGTH % 8) != 0:
                raise ValueError(f"{cls.__name__}: nonzero padding bits")
        return cls(bits)

    def hash_tree_root(self) -> bytes:
        return merkleize_chunks(
            pack_bytes_into_chunks(self.encode_bytes()), limit=(self.LENGTH + 255) // 256
        )

    def __repr__(self):
        return f"{type(self).__name__}({self._bits})"


class Bitlist(View):
    LIMIT = 0

    def __class_getitem__(cls, limit: int) -> type:
        if limit not in _bitlist_cache:
            _bitlist_cache[limit] = type(f"Bitlist[{limit}]", (Bitlist,), {"LIMIT": limit})
        return _bitlist_cache[limit]

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple, Bitlist)):
            bits = [bool(b) for b in args[0]]
        else:
            bits = [bool(b) for b in args]
        if len(bits) > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: {len(bits)} bits exceeds limit {self.LIMIT}")
        self._bits = bits

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    def __len__(self):
        return len(self._bits)

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        idx = int(i)
        if idx < 0:
            idx += len(self._bits)
        self._bits[idx] = bool(v)
        _bump(self)
        d = getattr(self, "_htr_dirty", None)
        if d is not None:
            d.add(idx // 256)

    def __iter__(self):
        return iter(self._bits)

    def append(self, v):
        if len(self._bits) + 1 > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: append exceeds limit")
        self._bits.append(bool(v))
        _bump(self)
        d = getattr(self, "_htr_dirty", None)
        if d is not None:
            d.add((len(self._bits) - 1) // 256)

    def __eq__(self, other):
        if isinstance(other, Bitlist):
            return self.LIMIT == other.LIMIT and self._bits == other._bits
        if isinstance(other, (list, tuple)):
            return self._bits == [bool(b) for b in other]
        return NotImplemented

    def __hash__(self):
        return hash((self.LIMIT, tuple(self._bits)))

    def encode_bytes(self) -> bytes:
        # serialized form includes the length-delimiting bit
        as_bytes = bytearray(_bits_to_bytes(self._bits + [True]))
        return bytes(as_bytes)

    @classmethod
    def decode_bytes(cls, data: bytes) -> "Bitlist":
        if len(data) == 0:
            raise ValueError(f"{cls.__name__}: empty encoding")
        if data[-1] == 0:
            raise ValueError(f"{cls.__name__}: missing delimiter bit")
        total_bits = (len(data) - 1) * 8 + data[-1].bit_length() - 1
        if total_bits > cls.LIMIT:
            raise ValueError(f"{cls.__name__}: {total_bits} bits exceeds limit {cls.LIMIT}")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(total_bits)]
        return cls(bits)

    def _bit_chunk(self, ci: int) -> bytes:
        return _bits_to_bytes(self._bits[ci * 256 : (ci + 1) * 256]).ljust(32, b"\x00")

    def hash_tree_root(self) -> bytes:
        """Layer-tree cached (see _ChunkTree): only chunks holding touched
        bits re-pack and re-hash; a shrink falls back to a full rebuild."""
        depth = _type_depth((self.LIMIT + 255) // 256)
        nbits = len(self._bits)
        n_chunks = (nbits + 255) // 256
        tree = getattr(self, "_htr_tree", None)
        dirty = getattr(self, "_htr_dirty", None)
        prev_nbits = getattr(self, "_htr_nbits", None)
        if tree is None or dirty is None or prev_nbits is None or nbits < prev_nbits:
            tree = _ChunkTree(depth, pack_bytes_into_chunks(_bits_to_bytes(self._bits)))
            self._htr_tree = tree
        else:
            _merkle_levels.counters["cache_hits"] += 1
            prev_chunks = tree.n_chunks()
            tree.update(
                {ci: self._bit_chunk(ci) for ci in dirty if ci < prev_chunks},
                [self._bit_chunk(ci) for ci in range(prev_chunks, n_chunks)],
            )
        self._htr_dirty = set()
        self._htr_nbits = nbits
        return mix_in_length(tree.root(), nbits)

    def __repr__(self):
        return f"{type(self).__name__}({self._bits})"


# ---------------------------------------------------------------------------
# Vector / List
# ---------------------------------------------------------------------------

_vector_cache: Dict[Tuple[type, int], type] = {}
_list_cache: Dict[Tuple[type, int], type] = {}


def _coerce_elem(typ: Type[View], v: Any) -> View:
    if type(v) is typ:
        return v
    if isinstance(v, typ) and is_basic_type(typ):
        return v  # subclass of a basic type (e.g. Slot for uint64) keeps identity
    return typ.coerce_view(v) if not isinstance(v, typ) else v


def _store_elem(typ: Type[View], v: Any) -> View:
    """Coerce + snapshot a value being stored into a composite."""
    v = _coerce_elem(typ, v)
    if not is_basic_type(typ) and not isinstance(v, bytes) and not isinstance(typ, type(None)):
        if isinstance(v, (Container, ComplexSeries, Bitvector, Bitlist, Union)):
            v = v.copy()
    return v


class ComplexSeries(View):
    """Shared implementation of Vector/List of non-byte elements."""

    ELEM_TYPE: Type[View] = None  # type: ignore

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)) and not isinstance(
            args[0], ByteVector
        ):
            elems = list(args[0])
        elif len(args) == 1 and isinstance(args[0], ComplexSeries):
            elems = list(args[0])
        else:
            elems = list(args)
        self._elems = [_store_elem(self.ELEM_TYPE, e) for e in elems]
        self._check_init_length()

    def _check_init_length(self):
        raise NotImplementedError

    def __len__(self):
        return len(self._elems)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._elems[i]
        return self._elems[int(i)]

    def __setitem__(self, i, v):
        idx = int(i)
        if idx < 0:
            idx += len(self._elems)
        self._elems[idx] = _store_elem(self.ELEM_TYPE, v)
        self._mark_dirty(idx)

    def __iter__(self):
        return iter(self._elems)

    # -- incremental merkleization machinery -------------------------------

    def _mark_dirty(self, idx: int) -> None:
        _bump(self)
        d = getattr(self, "_htr_dirty", None)
        if d is not None:
            d.add(idx)

    def _invalidate_htr(self) -> None:
        _bump(self)
        self._htr_tree = None
        self._htr_dirty = None
        # element-root caches must die with the tree: pop's splice path
        # would otherwise resurrect stale roots whose dirty marks were
        # discarded here
        self._htr_eroots = None
        self._htr_etags = None

    def _basic_chunk(self, ci: int, per: int) -> bytes:
        seg = self._elems[ci * per : (ci + 1) * per]
        return b"".join(e.encode_bytes() for e in seg).ljust(32, b"\x00")

    def _chunks_root(self) -> bytes:
        """Bottom merkleization (no length mix-in) with layer-tree caching:
        only dirty chunks/elements re-hash; the root path updates in
        O(log n) per dirty chunk. Falls back to a full (native-batched)
        rebuild when the cache is absent or the series shrank."""
        typ = type(self)
        depth = _type_depth(chunk_count(typ))
        basic = is_basic_type(self.ELEM_TYPE)
        tree: Optional[_ChunkTree] = getattr(self, "_htr_tree", None)
        dirty = getattr(self, "_htr_dirty", None)

        if basic:
            es = self.ELEM_TYPE.type_byte_length()
            per = 32 // es
            n_chunks = (len(self._elems) + per - 1) // per
            if tree is None or dirty is None or n_chunks < tree.n_chunks():
                raw = None
                if len(self._elems) >= 256 and _merkle_levels.plane_enabled():
                    raw = _get_merkle_plane().packed_basic_raw(
                        self.ELEM_TYPE, self._elems)
                if raw is None:
                    raw = b"".join(e.encode_bytes() for e in self._elems)
                tree = _ChunkTree(depth, pack_bytes_into_chunks(raw))
                self._htr_tree = tree
            else:
                _merkle_levels.counters["cache_hits"] += 1
                prev = tree.n_chunks()
                dchunks = {i // per for i in dirty if i // per < prev}
                if n_chunks > prev and prev > 0:
                    dchunks.add(prev - 1)  # boundary chunk gained elements
                tree.update(
                    {ci: self._basic_chunk(ci, per) for ci in dchunks},
                    [self._basic_chunk(ci, per)
                     for ci in range(prev, n_chunks)],
                )
            self._htr_dirty = set()
            return tree.root()

        # composite elements: cache per-element roots + mutation stamps
        eroots = getattr(self, "_htr_eroots", None)
        etags = getattr(self, "_htr_etags", None)
        n = len(self._elems)
        if tree is None or eroots is None or n < len(eroots):
            # cold build: the cross-element plane computes EVERY element
            # root column-wise through batched native level hashing;
            # dynamically-shaped element types fall back per element
            eroots = None
            if n >= 8:
                eroots = _get_merkle_plane().batched_element_roots(self._elems)
            if eroots is None:
                eroots = [e.hash_tree_root() for e in self._elems]
            if (issubclass(self.ELEM_TYPE, Container)
                    and not _container_stamp_fields(self.ELEM_TYPE)):
                etags = [getattr(e, "_mut", 0) for e in self._elems]
            else:
                etags = [_deep_stamp(e) for e in self._elems]
            self._htr_tree = tree = _ChunkTree(depth, list(eroots))
            self._htr_eroots = eroots
            self._htr_etags = etags
            self._htr_dirty = set()
            return tree.root()

        _merkle_levels.counters["cache_hits"] += 1
        # deep mutations through read aliases: elements whose stamp moved
        if _mutable_core(self.ELEM_TYPE):
            dirty = set(dirty)
            elems = self._elems
            if (issubclass(self.ELEM_TYPE, Container)
                    and not _container_stamp_fields(self.ELEM_TYPE)):
                # leaf-only containers (e.g. Validator): the deep stamp
                # IS the element's own _mut — scan without the recursive
                # call (this scan runs per warm root over the whole
                # series, so it is the registry re-root's hot loop)
                for i in range(len(eroots)):
                    if getattr(elems[i], "_mut", 0) != etags[i]:
                        dirty.add(i)
            else:
                for i in range(len(eroots)):
                    if _deep_stamp(elems[i]) != etags[i]:
                        dirty.add(i)
        updates = {}
        for i in sorted(d for d in dirty if d < len(eroots)):
            e = self._elems[i]
            r = e.hash_tree_root()
            etags[i] = _deep_stamp(e)
            if r != eroots[i]:
                eroots[i] = r
                updates[i] = r
        appends = []
        for i in range(len(eroots), n):  # appended elements
            e = self._elems[i]
            r = e.hash_tree_root()
            eroots.append(r)
            etags.append(_deep_stamp(e))
            appends.append(r)
        tree.update(updates, appends)
        self._htr_dirty = set()
        return tree.root()

    def __contains__(self, v):
        return v in self._elems

    def count(self, v):
        return sum(1 for e in self._elems if e == v)

    def index(self, v):
        for i, e in enumerate(self._elems):
            if e == v:
                return i
        raise ValueError(f"{v!r} not in series")

    def __eq__(self, other):
        if isinstance(other, ComplexSeries):
            # element types are compared by NAME: each built fork module
            # declares its own classes, and same-shape values must compare
            # equal across modules (see Container.__eq__)
            return (
                (self.ELEM_TYPE is other.ELEM_TYPE
                 or self.ELEM_TYPE.__name__ == other.ELEM_TYPE.__name__)
                and type(self).__name__.split("[")[0] == type(other).__name__.split("[")[0]
                and self._elems == other._elems
            )
        if isinstance(other, (list, tuple)):
            return self._elems == list(other)
        return NotImplemented

    def __hash__(self):
        return hash(self.hash_tree_root())

    def encode_bytes(self) -> bytes:
        return _serialize_series(self.ELEM_TYPE, self._elems)

    def __repr__(self):
        return f"{type(self).__name__}({self._elems})"


class Vector(ComplexSeries):
    LENGTH = 0

    def __class_getitem__(cls, params) -> type:
        elem_type, length = params
        key = (elem_type, length)
        if key not in _vector_cache:
            _vector_cache[key] = type(
                f"Vector[{elem_type.__name__},{length}]",
                (Vector,),
                {"ELEM_TYPE": elem_type, "LENGTH": length},
            )
        return _vector_cache[key]

    def _check_init_length(self):
        if len(self._elems) == 0:
            self._elems = [self.ELEM_TYPE.default() for _ in range(self.LENGTH)]
        if len(self._elems) != self.LENGTH:
            raise ValueError(
                f"{type(self).__name__}: expected {self.LENGTH} elements, got {len(self._elems)}"
            )

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return cls.ELEM_TYPE.is_fixed_byte_length()

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.ELEM_TYPE.type_byte_length() * cls.LENGTH

    @classmethod
    def decode_bytes(cls, data: bytes) -> "Vector":
        elems = _deserialize_series(cls.ELEM_TYPE, data, exact_count=cls.LENGTH)
        return cls(elems)

    def hash_tree_root(self) -> bytes:
        return self._chunks_root()


class List(ComplexSeries):
    LIMIT = 0

    def __class_getitem__(cls, params) -> type:
        elem_type, limit = params
        limit = int(limit)
        key = (elem_type, limit)
        if key not in _list_cache:
            _list_cache[key] = type(
                f"List[{elem_type.__name__},{limit}]",
                (List,),
                {"ELEM_TYPE": elem_type, "LIMIT": limit},
            )
        return _list_cache[key]

    def _check_init_length(self):
        if len(self._elems) > self.LIMIT:
            raise ValueError(
                f"{type(self).__name__}: {len(self._elems)} elements exceeds limit {self.LIMIT}"
            )

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    def append(self, v):
        if len(self._elems) + 1 > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: append exceeds limit {self.LIMIT}")
        self._elems.append(_store_elem(self.ELEM_TYPE, v))
        self._mark_dirty(len(self._elems) - 1)

    def pop(self, i=-1):
        idx = int(i)
        if idx < 0:
            idx += len(self._elems)
        v = self._elems.pop(idx)
        _bump(self)
        eroots = getattr(self, "_htr_eroots", None)
        if eroots is not None and idx < len(eroots):
            # composite path: splice the cached element root/tag out and
            # rebuild the layer tree from cached roots (no element rehash);
            # pending dirty marks shift down with the spliced indices
            del eroots[idx]
            del self._htr_etags[idx]
            self._htr_tree = _ChunkTree(
                _type_depth(chunk_count(type(self))), list(eroots)
            )
            d = getattr(self, "_htr_dirty", None) or set()
            self._htr_dirty = {j - 1 if j > idx else j for j in d if j != idx}
        else:
            self._invalidate_htr()  # basic path: repack chunks on next hash
        return v

    @classmethod
    def decode_bytes(cls, data: bytes) -> "List":
        elems = _deserialize_series(cls.ELEM_TYPE, data, limit=cls.LIMIT)
        return cls(elems)

    def hash_tree_root(self) -> bytes:
        return mix_in_length(self._chunks_root(), len(self._elems))


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


class Container(View):
    _field_types: "Dict[str, Type[View]]" = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields: Dict[str, Type[View]] = {}
        for base in reversed(cls.__mro__):
            anns = base.__dict__.get("__annotations__", {})
            for name, typ in anns.items():
                if name.startswith("_"):
                    continue
                fields[name] = typ
        cls._field_types = fields

    @classmethod
    def fields(cls) -> "Dict[str, Type[View]]":
        return cls._field_types

    def __init__(self, **kwargs):
        for name, typ in self._field_types.items():
            if name in kwargs:
                object.__setattr__(self, name, _store_elem(typ, kwargs.pop(name)))
            else:
                object.__setattr__(self, name, typ.default())
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unknown fields {list(kwargs)}")

    def __setattr__(self, name, value):
        typ = self._field_types.get(name)
        if typ is None:
            raise AttributeError(f"{type(self).__name__} has no SSZ field {name!r}")
        object.__setattr__(self, name, _store_elem(typ, value))
        _bump(self)

    def __eq__(self, other):
        if type(other) is not type(self):
            # same field names (e.g. the same container re-declared in a later
            # fork's built module) — compare by value; the field TYPES are
            # distinct classes per built module, so compare names only
            if isinstance(other, Container) and list(other._field_types) == list(self._field_types):
                pass
            else:
                return NotImplemented
        return all(
            getattr(self, n) == getattr(other, n) for n in self._field_types
        )

    @classmethod
    def coerce_view(cls, value: Any) -> "Container":
        if isinstance(value, cls):
            return value
        if isinstance(value, Container) and list(value._field_types) == list(cls._field_types):
            # same field names (e.g. the same container re-declared in a later
            # fork's built module, or an upgrade_to_* carrying fields across):
            # rebuild field-by-field, coercing recursively
            return cls(**{n: getattr(value, n) for n in cls._field_types})
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot coerce {type(value).__name__} to {cls.__name__}")

    def __hash__(self):
        return hash(self.hash_tree_root())

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return all(t.is_fixed_byte_length() for t in cls._field_types.values())

    @classmethod
    def type_byte_length(cls) -> int:
        return sum(t.type_byte_length() for t in cls._field_types.values())

    def encode_bytes(self) -> bytes:
        fixed_parts = []
        variable_parts = []
        for name, typ in self._field_types.items():
            v = getattr(self, name)
            if typ.is_fixed_byte_length():
                fixed_parts.append(v.encode_bytes())
                variable_parts.append(b"")
            else:
                fixed_parts.append(None)
                variable_parts.append(v.encode_bytes())
        fixed_len = sum(len(p) if p is not None else 4 for p in fixed_parts)
        offsets = []
        acc = fixed_len
        for vp, fp in zip(variable_parts, fixed_parts):
            if fp is None:
                offsets.append(acc)
                acc += len(vp)
        out = io.BytesIO()
        oi = 0
        for fp in fixed_parts:
            if fp is None:
                out.write(offsets[oi].to_bytes(4, "little"))
                oi += 1
            else:
                out.write(fp)
        for vp in variable_parts:
            out.write(vp)
        return out.getvalue()

    @classmethod
    def decode_bytes(cls, data: bytes) -> "Container":
        names = list(cls._field_types)
        types = list(cls._field_types.values())
        fixed_len = sum(t.type_byte_length() if t.is_fixed_byte_length() else 4 for t in types)
        if cls.is_fixed_byte_length():
            if len(data) != fixed_len:
                raise ValueError(f"{cls.__name__}: wrong length {len(data)}, expected {fixed_len}")
        elif len(data) < fixed_len:
            raise ValueError(f"{cls.__name__}: truncated ({len(data)} < {fixed_len})")
        values: Dict[str, View] = {}
        offsets = []  # (field index, offset)
        pos = 0
        for name, typ in zip(names, types):
            if typ.is_fixed_byte_length():
                n = typ.type_byte_length()
                values[name] = typ.decode_bytes(data[pos : pos + n])
                pos += n
            else:
                offsets.append((name, typ, int.from_bytes(data[pos : pos + 4], "little")))
                pos += 4
        if offsets:
            if offsets[0][2] != fixed_len:
                raise ValueError(f"{cls.__name__}: first offset {offsets[0][2]} != {fixed_len}")
            bounds = [o for (_, _, o) in offsets] + [len(data)]
            for i, (name, typ, off) in enumerate(offsets):
                end = bounds[i + 1]
                if off > end or end > len(data):
                    raise ValueError(f"{cls.__name__}: bad offsets")
                values[name] = typ.decode_bytes(data[off:end])
        obj = cls.__new__(cls)
        for name, typ in cls._field_types.items():
            object.__setattr__(obj, name, values[name])
        return obj

    def hash_tree_root(self) -> bytes:
        chunks = tuple(getattr(self, n).hash_tree_root() for n in self._field_types)
        return merkleize_chunks(chunks, limit=len(chunks) if chunks else 1)

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._field_types)
        return f"{type(self).__name__}({inner})"


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

_union_cache: Dict[tuple, type] = {}


class Union(View):
    OPTIONS: Tuple[Optional[Type[View]], ...] = ()

    def __class_getitem__(cls, params) -> type:
        if not isinstance(params, tuple):
            params = (params,)
        if params not in _union_cache:
            _union_cache[params] = type(
                f"Union[{','.join('None' if p is None else p.__name__ for p in params)}]",
                (Union,),
                {"OPTIONS": params},
            )
        return _union_cache[params]

    def __init__(self, selector: int = 0, value: Any = None):
        if selector < 0 or selector >= len(self.OPTIONS):
            raise ValueError(f"union selector {selector} out of range")
        typ = self.OPTIONS[selector]
        if typ is None:
            if value is not None:
                raise ValueError("union None option takes no value")
            self._value = None
        else:
            self._value = _store_elem(typ, value if value is not None else typ.default())
        self._selector = selector
        _bump(self)

    @property
    def selector(self) -> int:
        return self._selector

    @property
    def value(self):
        return self._value

    def change(self, selector: int, value: Any = None) -> None:
        """In-place re-tag (remerkleable's Union API, which the sharding
        draft's ShardWork status transitions use — reference
        specs/sharding/beacon-chain.md:616-667); propagates to any
        composite holding this view since composites store by reference."""
        Union.__init__(self, selector, value)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    def __eq__(self, other):
        if not isinstance(other, Union):
            return NotImplemented
        return (
            self.OPTIONS == other.OPTIONS
            and self._selector == other._selector
            and self._value == other._value
        )

    def __hash__(self):
        return hash(self.hash_tree_root())

    def encode_bytes(self) -> bytes:
        body = b"" if self._value is None else self._value.encode_bytes()
        return bytes([self._selector]) + body

    @classmethod
    def decode_bytes(cls, data: bytes) -> "Union":
        if len(data) == 0:
            raise ValueError("union: empty encoding")
        selector = data[0]
        if selector >= len(cls.OPTIONS):
            raise ValueError(f"union: selector {selector} out of range")
        typ = cls.OPTIONS[selector]
        if typ is None:
            if len(data) != 1:
                raise ValueError("union: None option with body")
            return cls(0)
        return cls(selector, typ.decode_bytes(data[1:]))

    def hash_tree_root(self) -> bytes:
        root = b"\x00" * 32 if self._value is None else self._value.hash_tree_root()
        return mix_in_selector(root, self._selector)

    def __repr__(self):
        return f"{type(self).__name__}(selector={self._selector}, value={self._value!r})"


# ---------------------------------------------------------------------------
# deep mutation stamps (incremental-merkleization change detection)
# ---------------------------------------------------------------------------

_STAMP_PLAN_CACHE: Dict[type, tuple] = {}


def _mutable_core(typ) -> bool:
    """Types whose INSTANCES can be mutated in place (and therefore carry
    `_mut` stamps). bytes-derived and int-derived views are immutable."""
    return isinstance(typ, type) and issubclass(
        typ, (Container, ComplexSeries, Bitvector, Bitlist, Union)
    )


def _container_stamp_fields(typ) -> tuple:
    """Per-class cache: field names whose subtree can mutate in place.
    Leaf-only containers (e.g. Validator — all uint/bytes fields) get an
    empty plan, making their deep stamp a single attribute read."""
    plan = _STAMP_PLAN_CACHE.get(typ)
    if plan is None:
        plan = tuple(
            n for n, t in typ._field_types.items() if _mutable_core(t)
        )
        _STAMP_PLAN_CACHE[typ] = plan
    return plan


def _deep_stamp(v) -> int:
    """Max mutation stamp over a view's whole subtree. Stamps are globally
    monotonic, so ANY in-place mutation below `v` after a recorded stamp
    strictly raises this value — the series caches compare it to decide
    which element roots to re-hash."""
    s = getattr(v, "_mut", 0)
    if isinstance(v, Container):
        for n in _container_stamp_fields(type(v)):
            s2 = _deep_stamp(object.__getattribute__(v, n))
            if s2 > s:
                s = s2
    elif isinstance(v, ComplexSeries):
        if _mutable_core(v.ELEM_TYPE):
            for e in v._elems:
                s2 = _deep_stamp(e)
                if s2 > s:
                    s = s2
    elif isinstance(v, Union):
        val = v._value
        if val is not None and _mutable_core(type(val)):
            s2 = _deep_stamp(val)
            if s2 > s:
                s = s2
    return s


# ---------------------------------------------------------------------------
# shared serialization helpers
# ---------------------------------------------------------------------------


def _serialize_series(elem_type: Type[View], elems: Sequence[View]) -> bytes:
    if elem_type.is_fixed_byte_length():
        return b"".join(e.encode_bytes() for e in elems)
    parts = [e.encode_bytes() for e in elems]
    offsets = []
    acc = 4 * len(parts)
    for p in parts:
        offsets.append(acc)
        acc += len(p)
    return b"".join(o.to_bytes(4, "little") for o in offsets) + b"".join(parts)


def _deserialize_series(
    elem_type: Type[View],
    data: bytes,
    exact_count: Optional[int] = None,
    limit: Optional[int] = None,
) -> list:
    if elem_type.is_fixed_byte_length():
        n = elem_type.type_byte_length()
        if len(data) % n != 0:
            raise ValueError(f"series: length {len(data)} not divisible by element size {n}")
        count = len(data) // n
        if exact_count is not None and count != exact_count:
            raise ValueError(f"series: expected {exact_count} elements, got {count}")
        if limit is not None and count > limit:
            raise ValueError(f"series: {count} elements exceeds limit {limit}")
        return [elem_type.decode_bytes(data[i * n : (i + 1) * n]) for i in range(count)]
    # variable-size elements: offset table
    if len(data) == 0:
        if exact_count not in (None, 0):
            raise ValueError("series: empty data for non-empty vector")
        return []
    first = int.from_bytes(data[0:4], "little")
    if first % 4 != 0 or first == 0:
        raise ValueError(f"series: invalid first offset {first}")
    count = first // 4
    if exact_count is not None and count != exact_count:
        raise ValueError(f"series: expected {exact_count} elements, got {count}")
    if limit is not None and count > limit:
        raise ValueError(f"series: {count} elements exceeds limit {limit}")
    offs = [int.from_bytes(data[i * 4 : i * 4 + 4], "little") for i in range(count)]
    offs.append(len(data))
    if offs[0] != count * 4:
        raise ValueError("series: first offset mismatch")
    out = []
    for i in range(count):
        if offs[i] > offs[i + 1] or offs[i + 1] > len(data):
            raise ValueError("series: bad offsets")
        out.append(elem_type.decode_bytes(data[offs[i] : offs[i + 1]]))
    return out


def chunk_count(typ: Type[View]) -> int:
    """Number of bottom-layer chunks for merkleization (ssz/simple-serialize.md:210-230)."""
    if is_basic_type(typ):
        return 1
    if issubclass(typ, ByteVector):
        return (typ.LENGTH + 31) // 32
    if issubclass(typ, ByteList):
        return (typ.LIMIT + 31) // 32
    if issubclass(typ, Bitvector):
        return (typ.LENGTH + 255) // 256
    if issubclass(typ, Bitlist):
        return (typ.LIMIT + 255) // 256
    if issubclass(typ, Vector):
        if is_basic_type(typ.ELEM_TYPE):
            return (typ.LENGTH * typ.ELEM_TYPE.type_byte_length() + 31) // 32
        return typ.LENGTH
    if issubclass(typ, List):
        if is_basic_type(typ.ELEM_TYPE):
            return (typ.LIMIT * typ.ELEM_TYPE.type_byte_length() + 31) // 32
        return typ.LIMIT
    if issubclass(typ, Container):
        return max(len(typ.fields()), 1)
    raise TypeError(f"chunk_count: unsupported type {typ}")
