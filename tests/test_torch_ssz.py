"""The port's SSZ engine, hashing and Merkleization plane
(consensus_specs_tpu_torch/utils/ssz/, merkle/, utils/hash_function.py,
utils/native_sha256.py) against the JAX package's, on the CPU.

Each case of tests/test_ssz.py, tests/test_ssz_incremental.py and
tests/test_merkle_plane.py runs on both packages as one test parametrised
over the package (``z`` is that package's SSZ surface, with the cases'
helper containers defined in its own types). Then the packages are held
to each other exactly: values drawn from a numpy seed, built once in each
package's types, give the same bytes, the same decodes and the same
``hash_tree_root``s through every hashing route (the per-tree layer cache,
the column-wise plane, the native C digests and hashlib), and the same
generalized indices. Classes never cross packages: values move by their
serialized bytes.
"""
import hashlib
import importlib
import random
import types

import numpy as np
import pytest
from tests.torch_threads import one_thread

one_thread()

PKGS = ("jax", "torch")
_ROOTS = {"jax": "consensus_specs_tpu", "torch": "consensus_specs_tpu_torch"}

sha = lambda b: hashlib.sha256(b).digest()  # noqa: E731


def _chunks(n, tag=0):
    return [sha(bytes([tag, i % 256, i // 256])) for i in range(n)]


def _surface(name):
    """One package's SSZ surface and the cases' helper types built in it."""
    root = _ROOTS[name]
    mod = lambda path: importlib.import_module(f"{root}.{path}")  # noqa: E731
    st = mod("utils.ssz.ssz_typing")
    z = types.SimpleNamespace(name=name, ssz_typing=st)
    for n in dir(st):
        if not n.startswith("__"):
            setattr(z, n, getattr(st, n))
    z.SSZList = st.List
    z.ssz_impl = mod("utils.ssz.ssz_impl")
    z.hash_tree_root = z.ssz_impl.hash_tree_root
    z.serialize = z.ssz_impl.serialize
    z.hash = mod("utils.hash_function").hash
    z.gindex = mod("utils.ssz.gindex")
    z.native_sha256 = mod("utils.native_sha256")
    z.mlevels = mod("merkle.levels")
    z.mcache = mod("merkle.cache")
    z.LevelTree = z.mcache.LevelTree
    z.plane = mod("merkle.plane")
    z.profiling = mod("ops.profiling")
    z.latency = mod("obs.latency")

    class FixedC(st.Container):
        a: st.uint64
        b: st.Bytes32

    class VarC(st.Container):
        a: st.uint64
        items: st.List[st.uint8, 32]
        b: st.uint16

    Bytes32 = st.ByteVector[32]

    class Inner(st.Container):
        a: st.uint64
        b: Bytes32

    class Outer(st.Container):
        slot: st.uint64
        inner: Inner
        bits: st.Bitlist[1024]
        nums: st.List[st.uint64, 1 << 40]
        inners: st.List[Inner, 1 << 30]
        roots: st.Vector[Bytes32, 16]

    class _Check(st.Container):
        epoch: st.uint64
        root: st.Bytes32

    class _Val(st.Container):
        pubkey: st.Bytes48
        balance: st.uint64
        slashed: st.boolean
        flags: st.Bitvector[9]
        words: st.Vector[st.uint64, 3]
        checkpoint: _Check

    def _val(i):
        return _Val(
            pubkey=st.Bytes48(bytes([i % 256]) * 48),
            balance=st.uint64(32 * 10**9 + i),
            slashed=st.boolean(i % 2),
            flags=st.Bitvector[9](*[bool((i >> b) & 1) for b in range(9)]),
            words=st.Vector[st.uint64, 3](st.uint64(i), st.uint64(i + 1),
                                          st.uint64(i + 2)),
            checkpoint=_Check(epoch=st.uint64(i),
                              root=st.Bytes32(sha(b"%d" % i))),
        )

    def fresh_root(v):
        """Root computed by a brand-new object with no caches."""
        t = type(v)
        if isinstance(v, st.Container):
            return t(**{n: getattr(v, n) for n in t.fields()}).hash_tree_root()
        if isinstance(v, (st.List, st.Vector)):
            return t(list(v)).hash_tree_root()
        if isinstance(v, st.Bitlist):
            return t(list(v)).hash_tree_root()
        raise TypeError(t)

    z.FixedC, z.VarC, z.Inner, z.Outer = FixedC, VarC, Inner, Outer
    z._Check, z._Val, z._val, z.fresh_root = _Check, _Val, _val, fresh_root
    return z


_SURFACES = {}


@pytest.fixture(params=PKGS)
def z(request):
    if request.param not in _SURFACES:
        _SURFACES[request.param] = _surface(request.param)
    return _SURFACES[request.param]


def both():
    for name in PKGS:
        if name not in _SURFACES:
            _SURFACES[name] = _surface(name)
    return _SURFACES["jax"], _SURFACES["torch"]



# -- the cases of tests/test_ssz.py

def test_uint_serialization(z):
    assert z.serialize(z.uint64(0)) == b"\x00" * 8
    assert z.serialize(z.uint64(0x0123456789ABCDEF)) == bytes.fromhex("efcdab8967452301")
    assert z.serialize(z.uint8(255)) == b"\xff"
    assert z.serialize(z.uint16(0x1234)) == b"\x34\x12"
    assert z.uint64.decode_bytes(b"\x01" + b"\x00" * 7) == 1


def test_uint_range_checks(z):
    with pytest.raises(ValueError):
        z.uint8(256)
    with pytest.raises(ValueError):
        z.uint64(-1)
    with pytest.raises(ValueError):
        z.uint64(2**64)


def test_uint_checked_arithmetic(z):
    a = z.uint64(2**62)
    assert a + a - a == a
    assert type(a + 1) is z.uint64
    with pytest.raises(ValueError):
        _ = z.uint64(2**63) * 2
    with pytest.raises(ValueError):
        _ = z.uint64(0) - 1
    assert z.uint64(7) // 2 == 3
    assert z.uint64(7) % 2 == 1


def test_uint_hash_tree_root(z):
    assert z.hash_tree_root(z.uint64(17)) == (17).to_bytes(8, "little") + b"\x00" * 24
    assert z.hash_tree_root(z.uint256(1)) == (1).to_bytes(32, "little")
    assert z.hash_tree_root(z.boolean(True)) == b"\x01" + b"\x00" * 31


def test_bytes32_htr_is_identity(z):
    v = z.Bytes32(b"\x42" * 32)
    assert z.hash_tree_root(v) == b"\x42" * 32
    assert z.serialize(v) == b"\x42" * 32


def test_bytes48_htr_pads_second_chunk(z):
    v = z.Bytes48(b"\x01" * 48)
    chunk0 = b"\x01" * 32
    chunk1 = b"\x01" * 16 + b"\x00" * 16
    assert z.hash_tree_root(v) == z.hash(chunk0 + chunk1)


def test_vector_of_uint64(z):
    v = z.Vector[z.uint64, 4](1, 2, 3, 4)
    expected_ser = b"".join(i.to_bytes(8, "little") for i in (1, 2, 3, 4))
    assert z.serialize(v) == expected_ser
    assert z.hash_tree_root(v) == expected_ser  # 32 bytes exactly = single chunk
    assert z.Vector[z.uint64, 4].decode_bytes(expected_ser) == v


def test_vector_wrong_length_rejected(z):
    with pytest.raises(ValueError):
        z.Vector[z.uint64, 4](1, 2, 3)


def test_list_mix_in_length(z):
    l = z.List[z.uint64, 1024](1, 2)
    chunks_root_input = z.serialize(l).ljust(32, b"\x00")
    # limit 1024 uint64 = 256 chunks -> depth 8 over zero-padded tree

    root = z.merkleize_chunks([chunks_root_input], limit=256)
    assert z.hash_tree_root(l) == z.hash(root + (2).to_bytes(32, "little"))
    assert z.List[z.uint64, 1024].decode_bytes(z.serialize(l)) == l


def test_list_limit_enforced(z):
    l = z.List[z.uint64, 2](1, 2)
    with pytest.raises(ValueError):
        l.append(3)
    with pytest.raises(ValueError):
        z.List[z.uint64, 2](1, 2, 3)


def test_empty_list_htr(z):

    l = z.List[z.uint64, 1024]()
    assert z.hash_tree_root(l) == z.hash(z.ZERO_HASHES[8] + b"\x00" * 32)


def test_bitvector(z):
    bv = z.Bitvector[10](1, 0, 1, 0, 0, 0, 0, 0, 1, 1)
    assert z.serialize(bv) == bytes([0b00000101, 0b00000011])
    assert z.Bitvector[10].decode_bytes(z.serialize(bv)) == bv
    with pytest.raises(ValueError):
        z.Bitvector[10].decode_bytes(bytes([0xFF, 0xFF]))  # nonzero padding


def test_bitlist(z):
    bl = z.Bitlist[16](1, 0, 1)
    # bits 101 + delimiter at position 3 -> 0b1101
    assert z.serialize(bl) == bytes([0b1101])
    assert z.Bitlist[16].decode_bytes(z.serialize(bl)) == bl
    assert len(bl) == 3
    empty = z.Bitlist[16]()
    assert z.serialize(empty) == bytes([1])
    assert z.Bitlist[16].decode_bytes(bytes([1])) == empty
    with pytest.raises(ValueError):
        z.Bitlist[16].decode_bytes(b"")
    with pytest.raises(ValueError):
        z.Bitlist[16].decode_bytes(bytes([0b101, 0]))  # missing delimiter
    with pytest.raises(ValueError):
        z.Bitlist[2].decode_bytes(bytes([0b1101]))  # 3 bits > limit 2


def test_container_fixed_serialization(z):
    c = z.FixedC(a=z.uint64(5), b=z.Bytes32(b"\x09" * 32))
    assert z.serialize(c) == (5).to_bytes(8, "little") + b"\x09" * 32
    assert z.FixedC.decode_bytes(z.serialize(c)) == c
    assert z.hash_tree_root(c) == z.hash(
        ((5).to_bytes(8, "little") + b"\x00" * 24) + b"\x09" * 32
    )


def test_container_variable_serialization(z):
    c = z.VarC(a=z.uint64(1), items=z.List[z.uint8, 32](7, 8, 9), b=z.uint16(2))
    ser = z.serialize(c)
    # fixed part: 8 bytes a + 4 byte offset + 2 bytes b = 14; offset = 14
    assert ser == (1).to_bytes(8, "little") + (14).to_bytes(4, "little") + (2).to_bytes(
        2, "little"
    ) + bytes([7, 8, 9])
    assert z.VarC.decode_bytes(ser) == c


def test_container_defaults_and_mutation(z):
    c = z.VarC()
    assert c.a == 0 and len(c.items) == 0
    c.a = 42
    assert c.a == z.uint64(42)
    c.items.append(z.uint8(1))
    assert len(c.items) == 1
    with pytest.raises(AttributeError):
        c.nonexistent = 1


def test_container_snapshot_on_store_alias_on_read(z):
    inner = z.FixedC(a=z.uint64(1))

    class Outer(z.Container):
        x: z.FixedC

    o = Outer(x=inner)
    inner.a = z.uint64(99)
    assert o.x.a == 1  # stored a snapshot
    o.x.a = z.uint64(5)
    assert o.x.a == 5  # reads alias


def test_container_copy_is_deep(z):
    c = z.VarC(a=z.uint64(1), items=z.List[z.uint8, 32](1))
    c2 = c.copy()
    c2.items.append(z.uint8(2))
    c2.a = z.uint64(9)
    assert len(c.items) == 1 and c.a == 1


def test_union(z):
    U = z.Union[None, z.uint16, z.uint32]
    u = U(1, z.uint16(0xAABB))
    assert z.serialize(u) == bytes([1, 0xBB, 0xAA])
    assert U.decode_bytes(z.serialize(u)) == u
    n = U(0)
    assert z.serialize(n) == bytes([0])
    assert z.hash_tree_root(u) == z.hash(
        (z.uint16(0xAABB).encode_bytes().ljust(32, b"\x00")) + (1).to_bytes(32, "little")
    )


def test_bytelist(z):
    bl = z.ByteList[64](b"abc")
    assert z.serialize(bl) == b"abc"
    assert z.ByteList[64].decode_bytes(b"abc") == bl
    with pytest.raises(ValueError):
        z.ByteList[2](b"abc")


def test_nested_variable_lists(z):
    T = z.List[z.List[z.uint8, 4], 4]
    v = T([z.List[z.uint8, 4](1, 2), z.List[z.uint8, 4](), z.List[z.uint8, 4](3)])
    ser = z.serialize(v)
    assert T.decode_bytes(ser) == v


def test_vector_of_containers_htr(z):
    T = z.Vector[z.FixedC, 2]
    v = T([z.FixedC(a=z.uint64(1)), z.FixedC(a=z.uint64(2))])
    assert z.hash_tree_root(v) == z.hash(
        v[0].hash_tree_root() + v[1].hash_tree_root()
    )


# -- the cases of tests/test_ssz_incremental.py

def test_chunk_tree_matches_merkleize(z):
    rng = random.Random(1)
    for limit in (1, 2, 3, 8, 33, 1 << 10):
        depth = (max(1, limit) - 1).bit_length() if limit > 1 else 0

        depth = z._type_depth(limit)
        for count in {c for c in (0, 1, 2, limit // 2, limit) if c <= limit}:
            chunks = [rng.randbytes(32) for _ in range(count)]
            tree = z._ChunkTree(depth, list(chunks))
            assert tree.root() == z.merkleize_chunks(chunks, limit=limit)
            # point updates keep matching
            for _ in range(min(count, 5)):
                i = rng.randrange(count)
                chunks[i] = rng.randbytes(32)
                tree.set_chunk(i, chunks[i])
                assert tree.root() == z.merkleize_chunks(chunks, limit=limit)
            # appends (with growth past power-of-two boundaries)
            for _ in range(3):
                if len(chunks) < limit:
                    c = rng.randbytes(32)
                    chunks.append(c)
                    tree.append(c)
                    assert tree.root() == z.merkleize_chunks(chunks, limit=limit)


def test_basic_list_incremental_mutations(z):
    rng = random.Random(2)
    nums = z.List[z.uint64, 1 << 40]([z.uint64(i) for i in range(1000)])
    assert nums.hash_tree_root() == z.fresh_root(nums)
    for _ in range(30):
        op = rng.randrange(3)
        if op == 0:
            nums[rng.randrange(len(nums))] = z.uint64(rng.randrange(1 << 60))
        elif op == 1:
            nums.append(z.uint64(rng.randrange(1 << 60)))
        else:
            nums.pop()
        assert nums.hash_tree_root() == z.fresh_root(nums)


def test_small_basic_types_incremental(z):
    b = z.List[z.boolean, 333]([z.boolean(i % 2) for i in range(100)])
    assert b.hash_tree_root() == z.fresh_root(b)
    b[7] = z.boolean(1)
    b.append(z.boolean(0))
    assert b.hash_tree_root() == z.fresh_root(b)
    u = z.List[z.uint256, 64]([z.uint256(i) for i in range(10)])
    assert u.hash_tree_root() == z.fresh_root(u)
    u[3] = z.uint256(1 << 200)
    assert u.hash_tree_root() == z.fresh_root(u)
    w = z.List[z.uint8, 100]([z.uint8(i) for i in range(50)])
    assert w.hash_tree_root() == z.fresh_root(w)
    w[49] = z.uint8(255)
    w.append(z.uint8(9))
    assert w.hash_tree_root() == z.fresh_root(w)


def test_composite_list_alias_mutation_detected(z):
    """The critical case: mutate elements through read aliases only."""
    inners = z.List[z.Inner, 1 << 30](
        [z.Inner(a=z.uint64(i), b=z.Bytes32(bytes([i % 256]) * 32)) for i in range(300)]
    )
    r0 = inners.hash_tree_root()
    assert r0 == z.fresh_root(inners)
    # deep alias mutation — the list's own mutators never run
    inners[123].a = z.uint64(777)
    r1 = inners.hash_tree_root()
    assert r1 != r0
    assert r1 == z.fresh_root(inners)
    # replacement via setitem
    inners[5] = z.Inner(a=z.uint64(5555), b=z.Bytes32(b"\xaa" * 32))
    assert inners.hash_tree_root() == z.fresh_root(inners)
    # append + mutate the appended element through its alias
    inners.append(z.Inner(a=z.uint64(1), b=z.Bytes32()))
    inners[-1].a = z.uint64(2)
    assert inners.hash_tree_root() == z.fresh_root(inners)


def test_nested_alias_mutation_two_levels_deep(z):
    """attestations[i].aggregation_bits[j] — mutation two levels below the
    caching series, invisible to both the list and the element container's
    setattr; only the deep-stamp scan can catch it."""

    class Att(z.Container):
        bits: z.Bitlist[2048]
        data: z.Inner

    atts = z.List[Att, 128](
        [Att(bits=z.Bitlist[2048]([False] * 64), data=z.Inner(a=z.uint64(i))) for i in range(10)]
    )
    r0 = atts.hash_tree_root()
    atts[4].bits[13] = True  # two levels deep
    r1 = atts.hash_tree_root()
    assert r1 != r0
    assert r1 == z.fresh_root(atts)
    atts[4].data.a = z.uint64(99)  # container-in-container
    assert atts.hash_tree_root() == z.fresh_root(atts)


def test_bitlist_incremental(z):
    rng = random.Random(3)
    bits = z.Bitlist[1 << 20]([bool(rng.randrange(2)) for _ in range(3000)])
    assert bits.hash_tree_root() == z.fresh_root(bits)
    for _ in range(20):
        if rng.randrange(2):
            bits[rng.randrange(len(bits))] = bool(rng.randrange(2))
        else:
            bits.append(bool(rng.randrange(2)))
        assert bits.hash_tree_root() == z.fresh_root(bits)


def test_container_of_everything_stays_consistent(z):
    rng = random.Random(4)
    o = z.Outer(
        slot=z.uint64(1),
        inner=z.Inner(a=z.uint64(2), b=z.Bytes32(b"\x01" * 32)),
        bits=z.Bitlist[1024]([False] * 300),
        nums=z.List[z.uint64, 1 << 40]([z.uint64(i) for i in range(500)]),
        inners=z.List[z.Inner, 1 << 30]([z.Inner(a=z.uint64(i)) for i in range(50)]),
        roots=z.Vector[z.Bytes32, 16]([z.Bytes32(bytes([i]) * 32) for i in range(16)]),
    )
    assert o.hash_tree_root() == z.fresh_root(o)
    for _ in range(25):
        op = rng.randrange(6)
        if op == 0:
            o.slot = z.uint64(int(o.slot) + 1)
        elif op == 1:
            o.inner.a = z.uint64(rng.randrange(1 << 30))
        elif op == 2:
            o.bits[rng.randrange(300)] = True
        elif op == 3:
            o.nums[rng.randrange(len(o.nums))] = z.uint64(rng.randrange(1 << 30))
        elif op == 4:
            o.inners[rng.randrange(len(o.inners))].b = z.Bytes32(rng.randbytes(32))
        else:
            o.roots[rng.randrange(16)] = z.Bytes32(rng.randbytes(32))
        assert o.hash_tree_root() == z.fresh_root(o)


def test_deepcopy_preserves_independence_and_correctness(z):
    import copy

    inners = z.List[z.Inner, 1 << 30]([z.Inner(a=z.uint64(i)) for i in range(100)])
    r0 = inners.hash_tree_root()  # warm the cache
    dup = copy.deepcopy(inners)
    assert dup.hash_tree_root() == r0
    # mutate the copy: original unaffected, copy correct
    dup[7].a = z.uint64(1 << 50)
    assert inners.hash_tree_root() == r0
    assert dup.hash_tree_root() == z.fresh_root(dup)
    # mutate the original: copy unaffected
    inners[3].a = z.uint64(42)
    assert inners.hash_tree_root() == z.fresh_root(inners)
    assert dup.hash_tree_root() == z.fresh_root(dup)


def test_pop_cannot_resurrect_stale_roots(z):
    """Regression: a pop with idx >= len(cached roots)
    invalidates the cache and discards pending dirty marks; a later pop
    must NOT rebuild a tree from the stale element roots (immutable
    elements like z.Bytes32 have no stamp scan to recover them)."""
    L = z.List[z.ByteVector[32], 1024]
    lst = L([z.ByteVector[32](bytes([i]) * 32) for i in range(10)])
    lst.hash_tree_root()
    lst[2] = z.ByteVector[32](b"\xaa" * 32)  # dirty mark {2}, not yet hashed
    lst.append(z.ByteVector[32](b"\xbb" * 32))
    lst.pop(10)  # idx >= len(eroots): invalidate path
    lst.pop(5)  # must not splice stale eroots back to life
    assert lst.hash_tree_root() == z.fresh_root(lst)


def test_incremental_is_sublinear(z):
    """One mutation in a large list must re-hash O(log n), not O(n): the
    second hash after a point update must do far less work than the first.
    Measured by z.hash-call counting (robust vs wall-clock noise)."""
    from unittest import mock

    st = z.ssz_typing

    nums = z.List[z.uint64, 1 << 40]([z.uint64(i) for i in range(4096)])
    nums.hash_tree_root()
    calls = {"n": 0}
    real = st.sha256

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    with mock.patch.object(st, "sha256", counting):
        nums[2000] = z.uint64(0)
        nums.hash_tree_root()
    # 1024 chunks -> full rebuild would be ~1023 hashes; the incremental
    # path is one route through the present layers (~10) plus the
    # zero-subtree fold up to the type depth (List[uint64, 2^40] -> depth
    # 38) and the length mix-in: O(log limit), independent of n
    assert calls["n"] <= 45, f"point update re-hashed {calls['n']} nodes"


# -- the cases of tests/test_merkle_plane.py

def test_mode_knob_env_and_forced(z, monkeypatch):
    monkeypatch.delenv(z.mlevels.MODE_ENV, raising=False)
    z.mlevels.configure(None)
    assert z.mlevels.requested_mode() == "auto"
    monkeypatch.setenv(z.mlevels.MODE_ENV, "python")
    assert z.mlevels.requested_mode() == "python"
    monkeypatch.setenv(z.mlevels.MODE_ENV, "bogus")
    assert z.mlevels.requested_mode() == "auto"  # unknown value -> default
    with z.mlevels.forced_mode("native"):
        assert z.mlevels.requested_mode() == "native"
        with z.mlevels.forced_mode("python"):  # innermost wins
            assert z.mlevels.requested_mode() == "python"
            assert not z.mlevels.plane_enabled()
            assert not z.mlevels.use_native()
        assert z.mlevels.requested_mode() == "native"
    monkeypatch.delenv(z.mlevels.MODE_ENV, raising=False)


def test_mode_knob_configure_and_invalid(z):
    z.mlevels.configure("python")
    try:
        assert z.mlevels.requested_mode() == "python"
        assert z.mlevels.mode() == "python"
    finally:
        z.mlevels.configure(None)
    with pytest.raises(ValueError):
        z.mlevels.configure("turbo")
    with pytest.raises(ValueError):
        with z.mlevels.forced_mode("turbo"):
            pass


def test_resolved_mode_auto_matches_availability(z):
    with z.mlevels.forced_mode("auto"):
        expected = "native" if z.mlevels._native() is not None else "python"
        assert z.mlevels.mode() == expected


def test_hash_level_matches_hashlib_both_modes(z):
    for n in (1, 2, 7, 8, 15, 16, 33):
        level = _chunks(n)
        ref_level = level + ([z.mlevels.ZERO_HASHES[3]] if n % 2 else [])
        ref = [sha(ref_level[2 * i] + ref_level[2 * i + 1])
               for i in range(len(ref_level) // 2)]
        for m in ("python", "native"):
            with z.mlevels.forced_mode(m):
                assert z.mlevels.hash_level(level, 3) == ref, (m, n)


def test_hash_pair_blob_matches_hashlib_both_modes(z):
    for n_pairs in (1, 8, 21):
        blob = b"".join(_chunks(2 * n_pairs))
        ref = b"".join(sha(blob[i << 6:(i + 1) << 6])
                       for i in range(n_pairs))
        for m in ("python", "native"):
            with z.mlevels.forced_mode(m):
                assert z.mlevels.hash_pair_blob(blob) == ref, (m, n_pairs)


def test_native_levels_counter_moves_when_native_runs(z):
    if z.mlevels._native() is None:
        pytest.skip("native sha256 library not built")
    before = z.mlevels.counters["native_levels"]
    with z.mlevels.forced_mode("native"):
        z.mlevels.hash_level(_chunks(32), 0)
    assert z.mlevels.counters["native_levels"] == before + 1
    # python mode must never touch the native counter
    before = z.mlevels.counters["native_levels"]
    with z.mlevels.forced_mode("python"):
        z.mlevels.hash_level(_chunks(32), 0)
    assert z.mlevels.counters["native_levels"] == before


def test_leveltree_root_matches_merkleize_chunks(z):
    for n in (0, 1, 2, 3, 8, 33):
        for limit in (64, 2**20):
            depth = (limit - 1).bit_length() if limit > 1 else 0
            tree = z.LevelTree(depth, _chunks(n))
            assert tree.root() == z.merkleize_chunks(_chunks(n), limit=limit), \
                (n, limit)


def test_leveltree_batched_update_matches_rebuild(z):
    depth = 12
    chunks = _chunks(40)
    tree = z.LevelTree(depth, chunks)
    updates = {i: sha(b"new%d" % i) for i in (0, 1, 13, 38, 39)}
    appends = [sha(b"app%d" % i) for i in range(5)]
    tree.update(updates, appends)
    for i, c in updates.items():
        chunks[i] = c
    chunks.extend(appends)
    assert tree.root() == z.LevelTree(depth, chunks).root()
    assert tree.root() == z.merkleize_chunks(chunks, limit=2**depth)


def test_leveltree_growth_past_power_of_two_boundary(z):
    depth = 10
    tree = z.LevelTree(depth, _chunks(3))
    chunks = _chunks(3)
    # grow 3 -> 4 -> 5 -> 9: crosses two power-of-two boundaries, the
    # top-layer rebuild path must keep pace with the oracle
    for i in range(6):
        c = sha(b"grow%d" % i)
        tree.append(c)
        chunks.append(c)
        assert tree.root() == z.merkleize_chunks(chunks, limit=2**depth), i


def test_leveltree_empty_and_single_ops(z):
    tree = z.LevelTree(8, [])
    assert tree.root() == z.mlevels.ZERO_HASHES[8]
    tree.append(sha(b"a"))
    assert tree.root() == z.merkleize_chunks([sha(b"a")], limit=2**8)
    tree.set_chunk(0, sha(b"b"))
    assert tree.root() == z.merkleize_chunks([sha(b"b")], limit=2**8)


def test_leveltree_dirty_nodes_counter_moves(z):
    tree = z.LevelTree(16, _chunks(64))
    before = z.mlevels.counters["dirty_nodes"]
    tree.set_chunk(17, sha(b"x"))
    moved = z.mlevels.counters["dirty_nodes"] - before
    # one dirty path: one parent per present level, far fewer than a
    # full 64-chunk rebuild
    assert 1 <= moved <= 7


def test_leveltree_is_the_ssz_chunk_tree(z):
    ssz_typing = z.ssz_typing

    assert ssz_typing._ChunkTree is z.mcache.LevelTree


def test_plane_roots_match_per_element_walk(z):
    if not z.mlevels.plane_enabled():
        pytest.skip("native sha256 library not built")
    plane = z.plane
    elems = [z._val(i) for i in range(20)]
    got = plane.batched_element_roots(elems)
    assert got is not None
    assert got == [bytes(e.hash_tree_root()) for e in elems]


def test_plane_unsupported_and_small_series_fall_back(z):
    plane = z.plane
    if not z.mlevels.plane_enabled():
        pytest.skip("native sha256 library not built")
    # below the batching threshold: not worth the column build
    assert plane.batched_element_roots(
        [z._val(i) for i in range(plane.MIN_PLANE_ELEMS - 1)]) is None
    # dynamically-shaped elements (length mix-in inside): must decline
    # and count the fallback
    inner = z.SSZList[z.uint64, 64]
    before = z.mlevels.counters["fallbacks"]
    assert plane.batched_element_roots(
        [inner(z.uint64(1)) for _ in range(20)]) is None
    assert z.mlevels.counters["fallbacks"] == before + 1
    # python mode: the oracle path may never consult the plane
    with z.mlevels.forced_mode("python"):
        assert plane.batched_element_roots(
            [z._val(i) for i in range(20)]) is None


def test_packed_basic_raw_widths(z):
    plane = z.plane
    vals = [z.uint64(i * 7) for i in range(10)]
    assert plane.packed_basic_raw(z.uint64, vals) == b"".join(
        v.encode_bytes() for v in vals)
    assert plane.packed_basic_raw(z.uint8, [z.uint8(3), z.uint8(250)]) == \
        bytes([3, 250])
    # non-machine-word width: decline, caller keeps its join
    assert plane.packed_basic_raw(z.uint256, [z.uint256(5)]) is None


def test_series_roots_identical_native_vs_python(z):
    views = [
        z.SSZList[z._Val, 2**30](*[z._val(i) for i in range(33)]),
        z.SSZList[z.uint64, 2**18](*[z.uint64(i * 3) for i in range(100)]),
        z.Bitlist[2**10](*[bool(i % 3 == 0) for i in range(77)]),
        z.Vector[z.Bytes32, 7](*[z.Bytes32(sha(b"%d" % i)) for i in range(7)]),
    ]
    for view in views:
        typ = type(view)
        enc = view.encode_bytes()
        with z.mlevels.forced_mode("native"):
            nat = bytes(typ.decode_bytes(enc).hash_tree_root())
        with z.mlevels.forced_mode("python"):
            ora = bytes(typ.decode_bytes(enc).hash_tree_root())
        assert nat == ora, typ


def test_incremental_reroot_matches_cold_rebuild(z):
    regs = z.SSZList[z._Val, 2**30](*[z._val(i) for i in range(40)])
    with z.mlevels.forced_mode("native"):
        regs.hash_tree_root()
        regs[7] = z._val(1000)
        regs[13].balance = z.uint64(1)  # deep aliased mutation
        regs.append(z._val(2000))
        warm = bytes(regs.hash_tree_root())
    with z.mlevels.forced_mode("python"):
        cold = bytes(type(regs).decode_bytes(regs.encode_bytes())
                     .hash_tree_root())
    assert warm == cold


def test_cache_hits_counter_moves_on_warm_reroot(z):
    regs = z.SSZList[z.uint64, 2**18](*[z.uint64(i) for i in range(64)])
    regs.hash_tree_root()
    before = z.mlevels.counters["cache_hits"]
    regs[5] = z.uint64(999)
    regs.hash_tree_root()
    assert z.mlevels.counters["cache_hits"] > before


def test_diff_check_passes_and_raises(z):
    plane = z.plane
    view = z.SSZList[z.uint64, 2**18](*[z.uint64(i) for i in range(50)])
    root = bytes(view.hash_tree_root())
    plane.diff_check(view, root)  # bit-identical: no raise
    with pytest.raises(AssertionError, match="MERKLE DIVERGED"):
        plane.diff_check(view, b"\xff" * 32)


def test_diff_env_gates_facade_assert(z, monkeypatch):
    ssz_impl = z.ssz_impl

    monkeypatch.setenv(z.mlevels.DIFF_ENV, "1")
    assert z.mlevels.diff_enabled()
    view = z.SSZList[z.uint64, 2**18](*[z.uint64(i) for i in range(50)])
    # the facade re-derives through the python oracle and asserts —
    # passing silently IS the test
    ssz_impl.hash_tree_root(view)
    monkeypatch.delenv(z.mlevels.DIFF_ENV)
    assert not z.mlevels.diff_enabled()


def test_export_gauges_publishes_merkle_family(z):
    profiling = z.profiling

    z.mlevels.counters["native_levels"] += 0  # family exists regardless
    z.mlevels.export_gauges()
    summ = profiling.summary()
    for key in ("merkle.native_levels", "merkle.cache_hits",
                "merkle.dirty_nodes", "merkle.fallbacks"):
        assert key in summ and "gauge" in summ[key], key


def test_note_root_seconds_fills_latency_stage(z):
    latency = z.latency

    z.mlevels.note_root_seconds(0.0017)
    snap = latency.snapshot()
    label = latency.stage_label("merkle_root")
    assert label in snap and snap[label]["n"] >= 1
    assert "merkle_root" in latency.STAGES


# -- the two packages held to each other, exactly ----------------------------


def _sink_types(z):
    """A container of every SSZ shape class, in ``z``'s types (cached)."""
    if hasattr(z, "Sink"):
        return z.Sink
    st = z.ssz_typing

    class Leaf(st.Container):
        epoch: st.uint64
        root: st.Bytes32
        flag: st.boolean

    class Sink(st.Container):
        u8: st.uint8
        u16: st.uint16
        u32: st.uint32
        u64: st.uint64
        u128: st.uint128
        u256: st.uint256
        flag: st.boolean
        b4: st.Bytes4
        b48: st.Bytes48
        b96: st.Bytes96
        blob: st.ByteList[300]
        bv: st.Bitvector[77]
        bl: st.Bitlist[2048]
        vec_u16: st.Vector[st.uint16, 21]
        vec_leaf: st.Vector[Leaf, 5]
        list_u64: st.List[st.uint64, 1 << 20]
        list_leaf: st.List[Leaf, 1 << 30]
        nested: st.List[st.List[st.uint8, 40], 16]
        choice: st.Union[None, st.uint32, Leaf]
        leaf: Leaf

    z.Leaf, z.Sink = Leaf, Sink
    return Sink


def _draw_sink(z, rng):
    """A random Sink value in ``z``'s types: the draws depend only on
    ``rng``, so one seed gives the same value in both packages."""
    Sink = _sink_types(z)
    st = z.ssz_typing
    u = lambda bits: int.from_bytes(rng.bytes(bits // 8), "little")  # noqa
    leaf = lambda: z.Leaf(epoch=st.uint64(u(64)),  # noqa: E731
                          root=st.Bytes32(rng.bytes(32)),
                          flag=st.boolean(int(rng.integers(2))))
    n_u64, n_leaf = int(rng.integers(0, 70)), int(rng.integers(0, 40))
    sel = int(rng.integers(3))
    choice_t = Sink._field_types["choice"]
    choice = (choice_t(0) if sel == 0 else
              choice_t(1, st.uint32(u(32))) if sel == 1 else
              choice_t(2, leaf()))
    return Sink(
        u8=st.uint8(u(8)), u16=st.uint16(u(16)), u32=st.uint32(u(32)),
        u64=st.uint64(u(64)), u128=st.uint128(u(128)),
        u256=st.uint256(u(256)), flag=st.boolean(int(rng.integers(2))),
        b4=st.Bytes4(rng.bytes(4)), b48=st.Bytes48(rng.bytes(48)),
        b96=st.Bytes96(rng.bytes(96)),
        blob=st.ByteList[300](rng.bytes(int(rng.integers(0, 300)))),
        bv=st.Bitvector[77](*[bool(b) for b in rng.integers(0, 2, 77)]),
        bl=st.Bitlist[2048](*[bool(b) for b in
                               rng.integers(0, 2, int(rng.integers(0, 700)))]),
        vec_u16=st.Vector[st.uint16, 21](*[st.uint16(u(16))
                                           for _ in range(21)]),
        vec_leaf=st.Vector[z.Leaf, 5](*[leaf() for _ in range(5)]),
        list_u64=st.List[st.uint64, 1 << 20](*[st.uint64(u(64))
                                               for _ in range(n_u64)]),
        list_leaf=st.List[z.Leaf, 1 << 30](*[leaf() for _ in range(n_leaf)]),
        nested=st.List[st.List[st.uint8, 40], 16]([
            st.List[st.uint8, 40]([st.uint8(u(8)) for _ in
                                   range(int(rng.integers(0, 40)))])
            for _ in range(int(rng.integers(0, 16)))]),
        choice=choice, leaf=leaf())


@pytest.mark.parametrize("seed", range(6))
def test_random_values_same_bytes_and_roots_in_both_packages(seed):
    jz, tz = both()
    jv = _draw_sink(jz, np.random.default_rng(seed))
    tv = _draw_sink(tz, np.random.default_rng(seed))
    data = jz.serialize(jv)
    assert tz.serialize(tv) == data
    assert bytes(tz.hash_tree_root(tv)) == bytes(jz.hash_tree_root(jv))
    # values move across by bytes: each package decodes the other's
    back = _sink_types(tz).decode_bytes(data)
    assert tz.serialize(back) == data
    assert bytes(back.hash_tree_root()) == bytes(jz.hash_tree_root(jv))
    for field in _sink_types(tz).fields():
        assert bytes(tz.hash_tree_root(getattr(tv, field))) == \
            bytes(jz.hash_tree_root(getattr(jv, field))), field


def test_mutation_sequence_same_roots_in_both_packages():
    """The same random mutations, through read aliases and mutators, on
    both packages' values: equal incremental roots after every step, and
    each equal to a cold decode's root."""
    jz, tz = both()
    vals = {z.name: _draw_sink(z, np.random.default_rng(99))
            for z in (jz, tz)}
    for z in (jz, tz):
        vals[z.name].hash_tree_root()  # warm every cache
    ops = np.random.default_rng(7)
    for step in range(40):
        op, a, b = (int(x) for x in ops.integers(0, 1 << 30, 3))
        roots = {}
        for z in (jz, tz):
            v, st = vals[z.name], z.ssz_typing
            kind = op % 7
            if kind == 0:
                v.list_u64.append(st.uint64(a))
            elif kind == 1 and len(v.list_u64):
                v.list_u64[a % len(v.list_u64)] = st.uint64(b)
            elif kind == 2 and len(v.list_leaf):
                v.list_leaf[a % len(v.list_leaf)].epoch = st.uint64(b)
            elif kind == 3 and len(v.bl):
                v.bl[a % len(v.bl)] = bool(b & 1)
            elif kind == 4:
                v.vec_leaf[a % 5].root = st.Bytes32(
                    hashlib.sha256(b"%d" % b).digest())
            elif kind == 5 and len(v.nested):
                v.nested[a % len(v.nested)].append(st.uint8(b % 256))
            else:
                v.leaf.flag = st.boolean(b & 1)
            roots[z.name] = bytes(v.hash_tree_root())
            cold = type(v).decode_bytes(v.encode_bytes())
            assert bytes(cold.hash_tree_root()) == roots[z.name], \
                (z.name, step)
        assert roots["torch"] == roots["jax"], step


def test_hashing_routes_give_the_same_roots_in_both_packages():
    """One registry-like series through every route: the per-element walk
    with hashlib (python mode), the column-wise plane with the native
    digests, and the incremental layer cache after mutations. Every route
    of both packages gives one root."""
    jz, tz = both()
    assert tz.mlevels.plane_enabled() == jz.mlevels.plane_enabled()
    got = {}
    for z in (jz, tz):
        typ = z.SSZList[z._Val, 2**40]
        elems = [z._val(i) for i in range(3 * z.plane.MIN_PLANE_ELEMS + 5)]
        data = typ(*elems).encode_bytes()
        with z.mlevels.forced_mode("python"):
            oracle = bytes(typ.decode_bytes(data).hash_tree_root())
        with z.mlevels.forced_mode("native"):
            fresh = typ.decode_bytes(data)
            column = z.plane.batched_element_roots(list(fresh))
            per_element = [bytes(e.hash_tree_root()) for e in fresh]
            native = bytes(fresh.hash_tree_root())
            fresh[3].balance = z.uint64(7)
            fresh.append(z._val(999))
            warm = bytes(fresh.hash_tree_root())
        with z.mlevels.forced_mode("python"):
            cold = bytes(typ.decode_bytes(fresh.encode_bytes())
                         .hash_tree_root())
        assert native == oracle and warm == cold, z.name
        if z.mlevels.plane_enabled():
            assert column == per_element, z.name
        got[z.name] = (oracle, warm, column)
    assert got["torch"] == got["jax"]


def test_native_sha256_digests_equal_hashlib_and_the_jax_package():
    jz, tz = both()
    rng = np.random.default_rng(5)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 300, 40)]
    pairs = rng.bytes(64 * 33)
    want_many = [sha(m) for m in msgs]
    want_pairs = b"".join(sha(pairs[i:i + 64]) for i in range(0, len(pairs), 64))
    assert tz.native_sha256.hash_many(msgs) == want_many
    assert tz.native_sha256.hash_pairs(pairs) == want_pairs
    assert jz.native_sha256.hash_many(msgs) == want_many
    assert tz.hash(pairs) == jz.hash(pairs) == sha(pairs)
    # the port's library lives in the package's own build directory
    if tz.native_sha256.available():
        path = str(tz.native_sha256.library_path())
        assert "consensus_specs_tpu_torch" in path and "_build" in path


def test_native_sha256_uses_hashlib_without_a_compiler(monkeypatch):
    """No C compiler: the port's binding answers through hashlib with the
    same digests (a host path, not a device fallback)."""
    _, tz = both()
    ns = tz.native_sha256
    monkeypatch.setattr(ns, "_lib", None)
    monkeypatch.setattr(ns, "library_path",
                        lambda: ns.BUILD_DIR / "libsha256_batch_absent.so")
    monkeypatch.setattr(ns, "_compiler", lambda: None)
    assert not ns.available()
    data = bytes(range(128))
    assert ns.hash_pairs(data) == sha(data[:64]) + sha(data[64:])
    assert ns.hash_many([b"a", b""]) == [sha(b"a"), sha(b"")]
    monkeypatch.setattr(ns, "_lib", None)


def test_generalized_indices_equal_in_both_packages():
    jz, tz = both()
    paths = [("u64",), ("leaf", "root"), ("list_u64", 17), ("list_leaf", 3,
             "epoch"), ("vec_leaf", 4, "flag"), ("bl", 1000), ("blob", 250),
             ("nested", 2, 39), ("vec_u16", 20), ("list_u64", "__len__")]
    for path in paths:
        j = jz.gindex.get_generalized_index(_sink_types(jz), *path)
        t = tz.gindex.get_generalized_index(_sink_types(tz), *path)
        assert int(t) == int(j), path
        assert tz.gindex.get_generalized_index_length(t) == \
            jz.gindex.get_generalized_index_length(j)
        assert int(tz.gindex.concat_generalized_indices(t, t)) == \
            int(jz.gindex.concat_generalized_indices(j, j))
