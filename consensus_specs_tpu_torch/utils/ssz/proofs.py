"""SSZ Merkle proofs over View objects: single proofs AND multiproofs (the
port's copy of consensus_specs_tpu/utils/ssz/proofs.py, over the port's own
SSZ views and its ``merkle/cache`` layer trees).

Own design; fills the role of remerkleable's backing-tree proof getters that
the reference uses for light-client proofs. The verification algebra
(branch/path/helper index computation, `calculate_merkle_root`,
`calculate_multi_merkle_root`) follows the normative algorithms of
reference ssz/merkle-proofs.md:249-357; construction (`get_tree_node`,
`build_proof`, `build_multiproof`) is this engine's own: a lazy descent of
the virtual zero-padded tree that reads interior nodes straight out of the
incremental-merkleization layer caches (`_ChunkTree`) when a series has
hashed before, so proving into a 300k-validator registry costs O(log n)
node lookups instead of re-merkleizing.

``build_proof(view, *path)`` returns the branch (deepest sibling first) for
the node addressed by ``path``, suitable for
``is_valid_merkle_branch(leaf, branch, depth, get_subtree_index(gindex), root)``
with ``gindex = get_generalized_index(type(view), *path)``. Paths into
packed basic vectors/lists resolve to the CHUNK holding the element
(merkle-proofs.md:89-98 item packing); the proven leaf is that chunk.
"""
from typing import Dict, List as PyList, Sequence, Set, Tuple

from .gindex import (  # noqa: F401  (API companions)
    GeneralizedIndex,
    generalized_index_parent,
    generalized_index_sibling,
    get_generalized_index,
    get_generalized_index_bit,
    get_generalized_index_length,
)
from .ssz_typing import (
    ZERO_HASHES, Bitlist, Bitvector, ByteList, ByteVector, Container, List,
    Union, Vector, View, _ChunkTree, _type_depth, chunk_count, is_basic_type,
    merkleize_chunks, pack_bytes_into_chunks,
)
from ..hash_function import hash as sha256


# ---------------------------------------------------------------------------
# proof-shape algebra (reference ssz/merkle-proofs.md:265-302)
# ---------------------------------------------------------------------------


def get_branch_indices(tree_index: GeneralizedIndex) -> PyList[GeneralizedIndex]:
    """Sister nodes along the path from ``tree_index`` to the root,
    deepest first (merkle-proofs.md:267-277)."""
    out = [generalized_index_sibling(tree_index)]
    while out[-1] > 1:
        out.append(generalized_index_sibling(generalized_index_parent(out[-1])))
    return out[:-1]


def get_path_indices(tree_index: GeneralizedIndex) -> PyList[GeneralizedIndex]:
    """Nodes along the path itself, deepest first (merkle-proofs.md:279-289)."""
    out = [tree_index]
    while out[-1] > 1:
        out.append(generalized_index_parent(out[-1]))
    return out[:-1]


def get_helper_indices(indices: Sequence[GeneralizedIndex]) -> PyList[GeneralizedIndex]:
    """All auxiliary nodes a multiproof of ``indices`` needs, in DECREASING
    order — which reduces to the single-proof branch order for one index
    (merkle-proofs.md:291-302)."""
    helpers: Set[GeneralizedIndex] = set()
    paths: Set[GeneralizedIndex] = set()
    for index in indices:
        helpers.update(get_branch_indices(index))
        paths.update(get_path_indices(index))
    return sorted(helpers.difference(paths), reverse=True)


# ---------------------------------------------------------------------------
# verification (reference ssz/merkle-proofs.md:304-357)
# ---------------------------------------------------------------------------


def calculate_merkle_root(leaf: bytes, proof: Sequence[bytes],
                          index: GeneralizedIndex) -> bytes:
    """Root implied by a single-leaf proof (merkle-proofs.md:306-315)."""
    assert len(proof) == get_generalized_index_length(index)
    node = bytes(leaf)
    for i, h in enumerate(proof):
        if get_generalized_index_bit(index, i):
            node = sha256(bytes(h) + node)
        else:
            node = sha256(node + bytes(h))
    return node


def verify_merkle_proof(leaf: bytes, proof: Sequence[bytes],
                        index: GeneralizedIndex, root: bytes) -> bool:
    return calculate_merkle_root(leaf, proof, index) == bytes(root)


def calculate_multi_merkle_root(leaves: Sequence[bytes],
                                proof: Sequence[bytes],
                                indices: Sequence[GeneralizedIndex]) -> bytes:
    """Root implied by a multiproof: iteratively hash any node pair whose
    parent is still unknown (merkle-proofs.md:325-349)."""
    assert len(leaves) == len(indices)
    helper_indices = get_helper_indices(indices)
    assert len(proof) == len(helper_indices)
    objects: Dict[int, bytes] = {}
    for index, node in zip(indices, leaves):
        objects[int(index)] = bytes(node)
    for index, node in zip(helper_indices, proof):
        objects[int(index)] = bytes(node)
    keys = sorted(objects.keys(), reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if k in objects and (k ^ 1) in objects and (k // 2) not in objects:
            objects[k // 2] = sha256(objects[(k | 1) ^ 1] + objects[k | 1])
            keys.append(k // 2)
        pos += 1
    return objects[1]


def verify_merkle_multiproof(leaves: Sequence[bytes], proof: Sequence[bytes],
                             indices: Sequence[GeneralizedIndex],
                             root: bytes) -> bool:
    return calculate_multi_merkle_root(leaves, proof, indices) == bytes(root)


# ---------------------------------------------------------------------------
# node resolution over live views (construction side; own design)
# ---------------------------------------------------------------------------


def _chunk_layer(view) -> Tuple[PyList[bytes], PyList[View]]:
    """Bottom chunk layer of a view's own subtree + per-chunk child views
    (children only where descent below the chunk continues into an object)."""
    if isinstance(view, Container):
        names = list(view.fields())
        children = [getattr(view, n) for n in names]
        return [c.hash_tree_root() for c in children], children
    if isinstance(view, (Vector, List)) and not is_basic_type(view.ELEM_TYPE):
        children = list(view)
        return [c.hash_tree_root() for c in children], children
    if isinstance(view, (Vector, List)):  # packed basics
        data = b"".join(e.encode_bytes() for e in view)
        return list(pack_bytes_into_chunks(data)), []
    if isinstance(view, (ByteVector, ByteList)):
        return list(pack_bytes_into_chunks(bytes(view))), []
    if isinstance(view, (Bitvector, Bitlist)):
        from .ssz_typing import _bits_to_bytes

        return list(pack_bytes_into_chunks(_bits_to_bytes(list(view)))), []
    raise TypeError(f"no chunk layer for {type(view).__name__}")


def _cached_tree(view) -> "_ChunkTree | None":
    """The incremental-merkleization layer cache. `get_tree_node` hashes
    the ROOT view once up front, which recursively refreshes every
    descendant series cache that could have gone stale — so reads here
    need no per-node re-warm (a warm per node would cost an O(n) stamp
    scan each)."""
    if isinstance(view, (Vector, List, Bitlist)):
        return getattr(view, "_htr_tree", None)
    return None


def _child_at(view: View, ci: int) -> View:
    """The child OBJECT under chunk ``ci`` — without touching any other
    element (descending must not re-hash the whole series)."""
    if isinstance(view, Container):
        names = list(view.fields())
        if ci >= len(names):
            raise ValueError(f"descent below empty chunk {ci} of "
                             f"{type(view).__name__}")
        return getattr(view, names[ci])
    if isinstance(view, (Vector, List)) and not is_basic_type(view.ELEM_TYPE):
        if ci >= len(view):
            raise ValueError(f"descent below chunk {ci} of "
                             f"{type(view).__name__} (no element there)")
        return view[ci]
    raise ValueError(f"descent below chunk {ci} of {type(view).__name__} "
                     "(no child object there)")


def _tree_interior_node(tree: _ChunkTree, height: int, idx: int) -> bytes:
    """Node at (height above chunks, index) of a cached layer tree,
    honoring virtual zero padding."""
    layers = tree.layers
    if height < len(layers):
        lay = layers[height]
        return lay[idx] if idx < len(lay) else ZERO_HASHES[height]
    if idx != 0 or not layers[0]:
        return ZERO_HASHES[height]
    node = layers[-1][0]
    for lv in range(len(layers) - 1, height):
        node = sha256(node + ZERO_HASHES[lv])
    return node


def _subtree_node(chunks: PyList[bytes], height: int, idx: int) -> bytes:
    """Node at (height, idx) over an explicit zero-padded chunk list."""
    if height == 0:
        return chunks[idx] if idx < len(chunks) else b"\x00" * 32
    width = 1 << height
    seg = chunks[idx * width : (idx + 1) * width]
    return merkleize_chunks(seg, limit=width)


def _node(view: View, gindex: GeneralizedIndex) -> bytes:
    """Node lookup WITHOUT the cache-refreshing root hash — callers must
    have hashed `view` first (get_tree_node/build_* do)."""
    bits = bin(int(gindex))[3:]  # path from the root: '0' = left
    return _descend(view, bits)


def get_tree_node(view: View, gindex: GeneralizedIndex) -> bytes:
    """Value of the Merkle-tree node at ``gindex`` of ``view``'s tree.
    Descends type structure top-down; series with warm incremental caches
    answer interior nodes in O(1). The root hash up front refreshes every
    descendant cache, so the descent never re-hashes unchanged data."""
    view.hash_tree_root()
    return _node(view, gindex)


def _descend(view: View, bits: str) -> bytes:
    if not bits:
        return view.hash_tree_root()

    # mix-in layer: left = data subtree, right = mix-in leaf
    if isinstance(view, (List, ByteList, Bitlist)):
        b, rest = bits[0], bits[1:]
        if b == "1":
            if rest:
                raise ValueError("descent below a length mix-in leaf")
            return len(view).to_bytes(32, "little")
        return _descend_data(view, rest)
    if isinstance(view, Union):
        b, rest = bits[0], bits[1:]
        if b == "1":
            if rest:
                raise ValueError("descent below a selector mix-in leaf")
            return view.selector.to_bytes(32, "little")
        if view.value is None:
            if rest:
                raise ValueError("descent below a None union value")
            return b"\x00" * 32
        return _descend(view.value, rest)
    return _descend_data(view, bits)


def _descend_data(view: View, bits: str) -> bytes:
    """Descend within a view's own chunk subtree (below any mix-in)."""
    depth = _type_depth(chunk_count(type(view)))
    if len(bits) < depth:
        # interior node of this subtree
        height = depth - len(bits)
        idx = int(bits, 2) if bits else 0
        tree = _cached_tree(view)
        if tree is not None:
            return _tree_interior_node(tree, height, idx)
        chunks, _ = _chunk_layer(view)
        return _subtree_node(chunks, height, idx)
    chunk_bits, rest = bits[:depth], bits[depth:]
    ci = int(chunk_bits, 2) if chunk_bits else 0
    if not rest:
        tree = _cached_tree(view)
        if tree is not None:
            return _tree_interior_node(tree, 0, ci)
        chunks, _ = _chunk_layer(view)
        return chunks[ci] if ci < len(chunks) else b"\x00" * 32
    return _descend(_child_at(view, ci), rest)


# ---------------------------------------------------------------------------
# proof construction
# ---------------------------------------------------------------------------


def build_proof(view: View, *path) -> PyList[bytes]:
    """Single-leaf Merkle branch for the node at ``path`` (deepest sibling
    first, matching ``is_valid_merkle_branch``'s indexing). Paths ending at
    a packed basic element prove the containing CHUNK."""
    g = get_generalized_index(type(view), *path)
    view.hash_tree_root()  # one cache refresh for the whole branch
    return [_node(view, i) for i in get_branch_indices(g)]


def build_multiproof(
    view: View, gindices: Sequence[GeneralizedIndex]
) -> Tuple[PyList[bytes], PyList[bytes]]:
    """(leaves, proof) for a multiproof of ``gindices``, verifiable with
    ``verify_merkle_multiproof(leaves, proof, gindices, root)``."""
    view.hash_tree_root()  # one cache refresh for the whole proof
    leaves = [_node(view, g) for g in gindices]
    proof = [_node(view, g) for g in get_helper_indices(gindices)]
    return leaves, proof


def build_proof_bundle(
    view: View,
    *,
    paths: Sequence[Tuple] = (),
    gindices: Sequence[GeneralizedIndex] = (),
) -> Tuple[Dict[Tuple, PyList[bytes]], PyList[bytes], PyList[bytes]]:
    """Every branch (one per ``paths`` entry) AND the multiproof of
    ``gindices`` off ONE cache-refreshing root hash, with node lookups
    memoized across all of them — branches and multiproof helpers share
    most of their upper tree, so per-artifact extraction (lightclient
    proof_tree) reads each cached level node once instead of re-walking
    the descent per gindex. Returns ``(branches_by_path, leaves, proof)``.
    """
    view.hash_tree_root()  # ONE refresh for everything extracted below
    memo: Dict[int, bytes] = {}

    def node(g: GeneralizedIndex) -> bytes:
        k = int(g)
        r = memo.get(k)
        if r is None:
            r = memo[k] = _node(view, g)
        return r

    branches = {
        tuple(path): [node(i) for i in
                      get_branch_indices(
                          get_generalized_index(type(view), *path))]
        for path in paths
    }
    leaves = [node(g) for g in gindices]
    proof = [node(g) for g in get_helper_indices(gindices)]
    return branches, leaves, proof
