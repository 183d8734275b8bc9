"""Level-by-level merkle helpers for deposit proofs and branch checks.

Own implementation for this harness (the reference keeps an equivalent
utility at eth2spec/utils/merkle_minimal.py; only the call surface is
shared). The deposit-contract twin and the test deposit helpers drive
these against ``is_valid_merkle_branch`` — the tree layout contract is:
``tree[d]`` is the list of nodes at depth ``d`` counted from the leaves,
odd tails hash against the zero-subtree of their depth, and a proof is
the sibling (or zero-hash) at every level below the root.
"""
from ..merkle import levels as _levels
from .ssz.ssz_typing import ZERO_HASHES as zerohashes  # shared table
from .ssz.ssz_typing import merkleize_chunks, next_power_of_two  # re-export

__all__ = [
    "zerohashes",
    "calc_merkle_tree_from_leaves",
    "get_merkle_tree",
    "get_merkle_root",
    "get_merkle_proof",
    "merkleize_chunks",
    "next_power_of_two",
]


def _parent_level(level, depth):
    """Hash one level into its parents; an odd tail pairs with the
    zero-subtree hash of ``depth`` (the canonical sparse-padding rule).
    Routed through the batched level hasher: one native call per level
    under CONSENSUS_SPECS_TPU_MERKLE=native/auto."""
    return _levels.hash_level(list(level), depth)


def calc_merkle_tree_from_leaves(values, layer_count=32):
    """All ``layer_count + 1`` levels of the padded tree over ``values``
    (level 0 = the leaves as given, last level = the single root)."""
    levels = [list(values)]
    for depth in range(layer_count):
        levels.append(_parent_level(levels[-1], depth))
    return levels


def get_merkle_tree(values, pad_to=None):
    """Tree sized for ``pad_to`` leaves (or the next power of two over the
    value count); an empty value list degenerates to the zero-subtree hash."""
    width = len(values) if pad_to is None else pad_to
    depth = max(0, width - 1).bit_length()
    if not values:
        return zerohashes[depth]
    return calc_merkle_tree_from_leaves(values, depth)


def get_merkle_root(values, pad_to=1):
    """Root only. ``pad_to=0`` is the empty tree (zero leaf hash)."""
    if pad_to == 0:
        return zerohashes[0]
    depth = (pad_to - 1).bit_length()
    if not values:
        return zerohashes[depth]
    return get_merkle_tree(values, pad_to)[depth][0]


def get_merkle_proof(tree, item_index, tree_len=None):
    """Sibling path for leaf ``item_index``: at each level take the node
    next to the ancestor, falling back to the level's zero-hash when the
    sibling sits past the stored (unpadded) level width."""
    branch = []
    index = item_index
    for depth in range(len(tree) if tree_len is None else tree_len):
        level = tree[depth]
        sibling = index ^ 1
        branch.append(level[sibling] if sibling < len(level) else zerohashes[depth])
        index >>= 1
    return branch
