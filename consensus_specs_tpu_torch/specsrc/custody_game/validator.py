# Custody Game (draft) — Honest Validator (executable spec source)
#
# Provenance: transcribed from the draft spec text (reference
# specs/custody_game/validator.md:76-92). The custody secret is the
# validator's randao-domain signature over the epoch that keys its current
# custody period — revealing it early is slashable
# (custody_game/beacon-chain.md:517-568).


def get_custody_secret(state: BeaconState,
                       validator_index: ValidatorIndex,
                       privkey: int,
                       epoch: Epoch = None) -> BLSSignature:
    if epoch is None:
        epoch = get_current_epoch(state)
    period = get_custody_period_for_validator(validator_index, epoch)
    epoch_to_sign = get_randao_epoch_for_custody_period(period, validator_index)
    domain = get_domain(state, DOMAIN_RANDAO, epoch_to_sign)
    signing_root = compute_signing_root(Epoch(epoch_to_sign), domain)
    return bls.Sign(privkey, signing_root)
