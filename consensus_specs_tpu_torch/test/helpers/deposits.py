"""Deposit-building helpers with real Merkle proofs
(reference: test/helpers/deposits.py).

Provenance: adapted from the reference's test/helpers/deposits.py — scenario code and comments largely follow the reference test suite; newer suites in this repo are original.
"""
from ...utils.merkle_minimal import calc_merkle_tree_from_leaves, get_merkle_proof
from .keys import privkeys, pubkeys


def build_deposit_data(spec, pubkey, privkey, amount, withdrawal_credentials, signed=False):
    deposit_data = spec.DepositData(
        pubkey=pubkey,
        withdrawal_credentials=withdrawal_credentials,
        amount=amount,
    )
    if signed:
        sign_deposit_data(spec, deposit_data, privkey)
    return deposit_data


def sign_deposit_data(spec, deposit_data, privkey):
    deposit_message = spec.DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    domain = spec.compute_domain(spec.DOMAIN_DEPOSIT)
    signing_root = spec.compute_signing_root(deposit_message, domain)
    deposit_data.signature = spec.bls.Sign(privkey, signing_root)


def build_deposit_tree_and_root(spec, deposit_data_list):
    """Return (tree, list_root): the depth-32 Merkle tree over deposit data
    roots, and the SSZ List root (with the length mix-in) the state commits to."""
    leaves = [spec.hash_tree_root(d) for d in deposit_data_list]
    tree = calc_merkle_tree_from_leaves(tuple(leaves), 32)
    root = spec.hash(tree[-1][0] + len(leaves).to_bytes(32, 'little'))
    return tree, root


def build_deposit(spec, deposit_data_list, pubkey, privkey, amount,
                  withdrawal_credentials, signed):
    deposit_data = build_deposit_data(spec, pubkey, privkey, amount,
                                      withdrawal_credentials, signed)
    index = len(deposit_data_list)
    deposit_data_list.append(deposit_data)
    return deposit_from_context(spec, deposit_data_list, index)


def deposit_from_context(spec, deposit_data_list, index):
    tree, root = build_deposit_tree_and_root(spec, deposit_data_list)
    # proof over the tree + the List-length mix-in as the (depth+1)th element
    proof = list(get_merkle_proof(tree, item_index=index, tree_len=32)) + [
        (index + 1).to_bytes(32, 'little')
    ]
    leaf = spec.hash_tree_root(deposit_data_list[index])
    assert spec.is_valid_merkle_branch(leaf, proof, spec.DEPOSIT_CONTRACT_TREE_DEPTH + 1, index, root)
    deposit = spec.Deposit(proof=proof, data=deposit_data_list[index])

    return deposit, root, deposit_data_list


def prepare_state_and_deposit(spec, state, validator_index, amount,
                              withdrawal_credentials=None, signed=False):
    """Prepare the state for the deposit, and create a deposit for the given
    validator, depositing the given amount."""
    deposit_data_list = []

    pubkey = pubkeys[validator_index]
    privkey = privkeys[validator_index]

    # insecurely use pubkey as withdrawal key if no credentials provided
    if withdrawal_credentials is None:
        withdrawal_credentials = spec.BLS_WITHDRAWAL_PREFIX + spec.hash(pubkey)[1:]

    deposit, root, deposit_data_list = build_deposit(
        spec,
        deposit_data_list,
        pubkey,
        privkey,
        amount,
        withdrawal_credentials,
        signed,
    )

    state.eth1_deposit_index = 0
    state.eth1_data.deposit_root = root
    state.eth1_data.deposit_count = len(deposit_data_list)
    return deposit


def run_deposit_processing(spec, state, deposit, validator_index, valid=True, effective=True):
    """Run ``process_deposit``, yielding (pre, deposit, post) parts;
    if ``valid == False``, run expecting ``AssertionError``."""
    from ..context import expect_assertion_error

    pre_validator_count = len(state.validators)
    pre_balance = 0
    if validator_index < pre_validator_count:
        pre_balance = state.balances[validator_index]

    yield 'pre', state
    yield 'deposit', deposit

    if not valid:
        expect_assertion_error(lambda: spec.process_deposit(state, deposit))
        yield 'post', None
        return

    spec.process_deposit(state, deposit)

    yield 'post', state

    if not effective or not spec.bls.KeyValidate(deposit.data.pubkey):
        assert len(state.validators) == pre_validator_count
        assert len(state.balances) == pre_validator_count
        if validator_index < pre_validator_count:
            assert state.balances[validator_index] == pre_balance
    else:
        if validator_index < pre_validator_count:
            # top-up
            assert len(state.validators) == pre_validator_count
            assert len(state.balances) == pre_validator_count
        else:
            # new validator
            assert len(state.validators) == pre_validator_count + 1
            assert len(state.balances) == pre_validator_count + 1
        assert state.balances[validator_index] == pre_balance + deposit.data.amount

    assert state.eth1_deposit_index == state.eth1_data.deposit_count
