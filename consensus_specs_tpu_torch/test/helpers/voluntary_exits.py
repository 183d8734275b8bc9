"""Voluntary-exit helpers (reference: test/helpers/voluntary_exits.py)."""
from .keys import privkeys


def prepare_signed_exits(spec, state, indices):
    def create_signed_exit(index):
        voluntary_exit = spec.VoluntaryExit(
            epoch=spec.get_current_epoch(state),
            validator_index=index,
        )
        return sign_voluntary_exit(spec, state, voluntary_exit, privkeys[index])

    return [create_signed_exit(index) for index in indices]


def sign_voluntary_exit(spec, state, voluntary_exit, privkey):
    domain = spec.get_domain(state, spec.DOMAIN_VOLUNTARY_EXIT, voluntary_exit.epoch)
    signing_root = spec.compute_signing_root(voluntary_exit, domain)
    return spec.SignedVoluntaryExit(
        message=voluntary_exit,
        signature=spec.bls.Sign(privkey, signing_root),
    )


def run_voluntary_exit_processing(spec, state, signed_voluntary_exit, valid=True):
    """Run ``process_voluntary_exit``, yielding (pre, op, post) parts;
    if ``valid == False``, run expecting ``AssertionError``."""
    from ..context import expect_assertion_error

    validator_index = signed_voluntary_exit.message.validator_index

    yield 'pre', state
    yield 'voluntary_exit', signed_voluntary_exit

    if not valid:
        expect_assertion_error(lambda: spec.process_voluntary_exit(state, signed_voluntary_exit))
        yield 'post', None
        return

    pre_exit_epoch = state.validators[validator_index].exit_epoch

    spec.process_voluntary_exit(state, signed_voluntary_exit)

    yield 'post', state

    assert pre_exit_epoch == spec.FAR_FUTURE_EPOCH
    assert state.validators[validator_index].exit_epoch < spec.FAR_FUTURE_EPOCH
