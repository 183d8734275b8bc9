"""`merkle` test-vector generator of the port: single Merkle proofs AND multiproofs
over BeaconState (reference: the altair light-client merkle single_proof
suite, format tests/formats/merkle/README.md — leaf, proof branch,
generalized index; multiproof algebra per ssz/merkle-proofs.md:249-357)."""
import sys
from random import Random

from ...builder import IMPLEMENTED_FORKS, build_spec_module
from ...utils.ssz.gindex import get_generalized_index
from ...utils.ssz.proofs import (
    build_multiproof,
    build_proof,
    verify_merkle_multiproof,
)
from ..gen_runner import run_generator
from ..gen_typing import TestCase, TestProvider

PATHS = [
    ("finalized_checkpoint_root", ("finalized_checkpoint", "root")),
    ("current_justified_checkpoint", ("current_justified_checkpoint",)),
    ("fork", ("fork",)),
    ("next_sync_committee", ("next_sync_committee",)),  # altair+
]


def _case(spec, state, path):
    def case_fn():
        gindex = get_generalized_index(spec.BeaconState, *path)
        leaf = state
        for p in path:
            leaf = getattr(leaf, p)
        branch = build_proof(state, *path)
        assert spec.is_valid_merkle_branch(
            leaf=leaf.hash_tree_root(),
            branch=branch,
            depth=spec.floorlog2(gindex),
            index=spec.get_subtree_index(gindex) if hasattr(spec, "get_subtree_index")
            else int(gindex) % (1 << (int(gindex).bit_length() - 1)),
            root=state.hash_tree_root(),
        )
        return [
            ("state", "ssz", state.encode_bytes()),
            ("proof", "data", {
                "leaf": "0x" + leaf.hash_tree_root().hex(),
                "leaf_index": int(gindex),
                "branch": ["0x" + b.hex() for b in branch],
            }),
        ]

    return case_fn


MULTI_PATH_SETS = [
    ("finality_and_fork", (("finalized_checkpoint", "root"), ("fork",))),
    ("light_client_pair", (("finalized_checkpoint", "root"), ("next_sync_committee",))),  # altair+
    ("checkpoints_and_slot", (("current_justified_checkpoint",), ("finalized_checkpoint",), ("slot",))),
]


def _multi_case(spec, state, path_set):
    def case_fn():
        gindices = [get_generalized_index(spec.BeaconState, *p) for p in path_set]
        leaves, proof = build_multiproof(state, gindices)
        assert verify_merkle_multiproof(
            leaves, proof, gindices, state.hash_tree_root()
        )
        return [
            ("state", "ssz", state.encode_bytes()),
            ("proof", "data", {
                "leaf_indices": [int(g) for g in gindices],
                "leaves": ["0x" + bytes(l).hex() for l in leaves],
                "proof": ["0x" + bytes(b).hex() for b in proof],
            }),
        ]

    return case_fn


def make_cases():
    rng = Random(1331)
    for preset in ("minimal",):
        for fork in IMPLEMENTED_FORKS:
            spec = build_spec_module(fork, preset)
            state = spec.BeaconState()
            state.slot = 77
            state.finalized_checkpoint.epoch = 3
            state.finalized_checkpoint.root = bytes(rng.getrandbits(8) for _ in range(32))
            for name, path in PATHS:
                if path[0] not in spec.BeaconState.fields():
                    continue
                yield TestCase(
                    fork_name=fork,
                    preset_name=preset,
                    runner_name="merkle",
                    handler_name="single_proof",
                    suite_name="pyspec_tests",
                    case_name=name,
                    case_fn=_case(spec, state, path),
                )
            for name, path_set in MULTI_PATH_SETS:
                if any(p[0] not in spec.BeaconState.fields() for p in path_set):
                    continue
                yield TestCase(
                    fork_name=fork,
                    preset_name=preset,
                    runner_name="merkle",
                    handler_name="multiproof",
                    suite_name="pyspec_tests",
                    case_name=name,
                    case_fn=_multi_case(spec, state, path_set),
                )


def main(args=None) -> int:
    provider = TestProvider(prepare=lambda: None, make_cases=make_cases)
    return run_generator("merkle", [provider], args=args)


if __name__ == "__main__":
    sys.exit(main())
