"""The fork-name constants and ``expect_assertion_error`` of the test
harness (the port's subset of consensus_specs_tpu/test/context.py: the
decorators and the spec-test runner are not ported yet).

(reference: tests/core/pyspec/eth2spec/test/context.py, helpers/constants.py)
"""
from ..utils import bls

PHASE0 = "phase0"
ALTAIR = "altair"
MERGE = "merge"
# Experimental draft forks (reference helpers/constants.py:12-14)
SHARDING = "sharding"
CUSTODY_GAME = "custody_game"
MINIMAL = "minimal"
MAINNET = "mainnet"
ALL_PHASES = (PHASE0, ALTAIR, MERGE)
EXPERIMENTAL_PHASES = (SHARDING, CUSTODY_GAME)
ALL_PRESETS = (MINIMAL, MAINNET)


def expect_assertion_error(fn):
    """(reference context.py:259-270; IndexError counts as a failed assert,
    and our SSZ layer raises ValueError where remerkleable did)"""
    bls_active = bls.bls_active
    try:
        fn()
    except (AssertionError, IndexError, ValueError):
        return
    except Exception:
        raise
    finally:
        bls.bls_active = bls_active
    raise AssertionError("expected an assertion error, but got none.")
