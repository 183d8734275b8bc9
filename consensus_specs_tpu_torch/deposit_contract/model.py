"""Pure-Python model of the deposit contract's incremental Merkle
accumulator, in the port (the counterpart of
consensus_specs_tpu/deposit_contract/model.py; the contract is
deposit_contract/deposit_contract.sol in this repo; fills the
role of the reference's solidity_deposit_contract + web3 harness,
reference specs/phase0/deposit-contract.md).

The model is the executable twin of the Solidity source: same state
(a branch cache + leaf count), same insert/carry algorithm, same
length-mixed root — so its outputs are directly checked against the
consensus spec's ``hash_tree_root``/``is_valid_merkle_branch`` in
tests/test_torch_deposit_contract.py. It also produces the per-leaf Merkle
proofs the spec's ``process_deposit`` consumes (the contract itself never
materializes proofs; an eth1 data provider reconstructs them from the
event log, which is what ``proof_at`` models).
"""
from typing import List

from ..utils.hash_function import hash as sha256

TREE_DEPTH = 32


def _zero_hashes():
    zh = [b"\x00" * 32]
    for _ in range(TREE_DEPTH):
        zh.append(sha256(zh[-1] + zh[-1]))
    return zh


ZERO_HASHES = _zero_hashes()


class DepositContractModel:
    def __init__(self):
        self.branch = [b"\x00" * 32] * TREE_DEPTH
        self.deposit_count = 0
        self._leaves: List[bytes] = []  # event log (for proof reconstruction)

    # -- the contract's own operations --------------------------------------

    def deposit(self, deposit_data_root: bytes) -> None:
        """Insert a DepositData hash_tree_root leaf (deposit())."""
        assert self.deposit_count < 2**TREE_DEPTH - 1, "merkle tree full"
        self.deposit_count += 1
        self._leaves.append(bytes(deposit_data_root))
        node = bytes(deposit_data_root)
        size = self.deposit_count
        for h in range(TREE_DEPTH):
            if size & 1:
                self.branch[h] = node
                return
            node = sha256(self.branch[h] + node)
            size >>= 1
        raise AssertionError("unreachable")

    def get_deposit_root(self) -> bytes:
        node = b"\x00" * 32
        size = self.deposit_count
        for h in range(TREE_DEPTH):
            if size & 1:
                node = sha256(self.branch[h] + node)
            else:
                node = sha256(node + ZERO_HASHES[h])
            size >>= 1
        return sha256(node + self.deposit_count.to_bytes(8, "little") + b"\x00" * 24)

    def get_deposit_count(self) -> bytes:
        return self.deposit_count.to_bytes(8, "little")

    # -- eth1-provider side: proof reconstruction from the event log --------

    def proof_at(self, index: int, deposit_count: int = None) -> List[bytes]:
        """Merkle branch for leaf ``index`` against the tree of the first
        ``deposit_count`` leaves, in is_valid_merkle_branch order (deepest
        first), with the length mix-in appended — depth TREE_DEPTH + 1,
        exactly what process_deposit verifies
        (reference specs/phase0/beacon-chain.md:1852-1860)."""
        if deposit_count is None:
            deposit_count = self.deposit_count
        assert 0 <= index < deposit_count <= len(self._leaves)
        layer = list(self._leaves[:deposit_count])
        proof = []
        idx = index
        for h in range(TREE_DEPTH):
            sibling = idx ^ 1
            proof.append(layer[sibling] if sibling < len(layer) else ZERO_HASHES[h])
            nxt = []
            for i in range(0, len(layer), 2):
                left = layer[i]
                right = layer[i + 1] if i + 1 < len(layer) else ZERO_HASHES[h]
                nxt.append(sha256(left + right))
            layer = nxt
            idx >>= 1
        proof.append(deposit_count.to_bytes(8, "little") + b"\x00" * 24)
        return proof
