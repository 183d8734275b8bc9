"""Fork predicates for test helpers that branch on the state/block shape.

(reference: test/helpers/constants.py fork-name registry :8-31; the reference
compares `spec.fork` against those names at helper branch points)
"""
from ..context import CUSTODY_GAME, MERGE, PHASE0, SHARDING


def is_post_altair(spec) -> bool:
    return spec.fork not in (PHASE0,)


def is_post_merge(spec) -> bool:
    return spec.fork in (MERGE, SHARDING, CUSTODY_GAME)


def is_post_sharding(spec) -> bool:
    # the draft forks layer on merge: phase0 < altair < merge < sharding <
    # custody_game (reference specs/custody_game/beacon-chain.md extends
    # sharding containers; sharding extends merge's)
    return spec.fork in (SHARDING, CUSTODY_GAME)


def is_post_custody_game(spec) -> bool:
    return spec.fork in (CUSTODY_GAME,)
