"""The port's deposit-contract model against the JAX package's: roots,
counts and proofs equal on seeded sequences (every prefix, every proof,
historical proofs), and the roots equal to the port's own SSZ engine
(consensus_specs_tpu_torch/deposit_contract/model.py)."""
from random import Random

import pytest

from consensus_specs_tpu.deposit_contract import (
    DepositContractModel as JaxModel,
)
from consensus_specs_tpu_torch.builder import build_spec_module
from consensus_specs_tpu_torch.deposit_contract import DepositContractModel
from tests.torch_threads import one_thread

one_thread()


def _leaves(rng, n):
    return [bytes(rng.getrandbits(8) for _ in range(32)) for _ in range(n)]


@pytest.mark.parametrize("seed", range(8))
def test_roots_and_proofs_equal_jax(seed):
    rng = Random(0xDE9051 + seed)
    n = rng.randint(1, 40)
    spec = build_spec_module("phase0", "minimal")
    leaf_list = spec.List[spec.Bytes32, 2 ** spec.DEPOSIT_CONTRACT_TREE_DEPTH]
    depth = spec.DEPOSIT_CONTRACT_TREE_DEPTH + 1
    model, jax_model = DepositContractModel(), JaxModel()
    leaves = _leaves(rng, n)
    for i, leaf in enumerate(leaves):
        model.deposit(leaf)
        jax_model.deposit(leaf)
        assert model.get_deposit_root() == jax_model.get_deposit_root()
        assert model.get_deposit_count() == jax_model.get_deposit_count() \
            == (i + 1).to_bytes(8, "little")
    root = model.get_deposit_root()
    assert root == spec.hash_tree_root(leaf_list(*leaves))
    for index in range(n):
        proof = model.proof_at(index)
        assert proof == jax_model.proof_at(index)
        assert spec.is_valid_merkle_branch(leaf=leaves[index], branch=proof,
                                           depth=depth, index=index,
                                           root=root)
    for count in sorted({1, n // 2 or 1, n}):
        for index in rng.sample(range(count), min(count, 3)):
            assert model.proof_at(index, deposit_count=count) == \
                jax_model.proof_at(index, deposit_count=count)


def test_deposit_data_roots_and_end_to_end_process_deposit():
    """DepositData leaves (signed with the port's oracle) through the
    model, the proof applied by the port's phase0 process_deposit."""
    from consensus_specs_tpu_torch.test.helpers.genesis import (
        create_genesis_state,
    )
    from consensus_specs_tpu_torch.test.helpers.keys import privkeys, pubkeys
    from consensus_specs_tpu_torch.utils import bls

    spec = build_spec_module("phase0", "minimal")
    saved = (bls._backend, bls.bls_active)
    bls.use_py_ecc()
    bls.bls_active = True
    try:
        state = create_genesis_state(
            spec, [spec.MAX_EFFECTIVE_BALANCE] * 8, spec.MAX_EFFECTIVE_BALANCE)
        new_index = len(state.validators)
        sk, pk = privkeys[new_index], pubkeys[new_index]
        creds = spec.BLS_WITHDRAWAL_PREFIX + spec.hash(pk)[1:]
        message = spec.DepositMessage(pubkey=pk, withdrawal_credentials=creds,
                                      amount=spec.MAX_EFFECTIVE_BALANCE)
        domain = spec.compute_domain(spec.DOMAIN_DEPOSIT)
        data = spec.DepositData(
            pubkey=pk, withdrawal_credentials=creds,
            amount=spec.MAX_EFFECTIVE_BALANCE,
            signature=bls.Sign(sk, spec.compute_signing_root(message, domain)))
        model, jax_model = DepositContractModel(), JaxModel()
        model.deposit(spec.hash_tree_root(data))
        jax_model.deposit(bytes(spec.hash_tree_root(data)))
        assert model.get_deposit_root() == jax_model.get_deposit_root()
        state.eth1_data = spec.Eth1Data(deposit_root=model.get_deposit_root(),
                                        deposit_count=model.deposit_count,
                                        block_hash=b"\x22" * 32)
        state.eth1_deposit_index = 0
        spec.process_deposit(state, spec.Deposit(proof=model.proof_at(0),
                                                 data=data))
        assert len(state.validators) == new_index + 1
        assert state.validators[new_index].pubkey == pk
        assert state.balances[new_index] == spec.MAX_EFFECTIVE_BALANCE
    finally:
        bls._backend, bls.bls_active = saved
