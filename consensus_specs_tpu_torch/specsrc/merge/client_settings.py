# The Merge — client settings: the TTD-override semantics, executable
#
# Reference specs/merge/client-settings.md: clients MUST provide a
# `--terminal-total-difficulty-override` setting. It exists because the
# terminal total difficulty is a RUNTIME decision — if PoW difficulty
# drifts, the community can coordinate a new TTD without shipping new
# binaries — so the override must beat the configured value the moment it
# is supplied, and terminal-block detection must read the EFFECTIVE value,
# never `config.TERMINAL_TOTAL_DIFFICULTY` directly. These helpers are
# that precedence rule as code; `apply_terminal_total_difficulty_override`
# is the whole mutation a client performs when the operator passes the
# flag.


def get_effective_terminal_total_difficulty(ttd_override: Optional[uint256]) -> uint256:
    """The TTD terminal-block detection must use: the operator's override
    when one was supplied, the runtime config's value otherwise
    (client-settings.md "Override terminal total difficulty")."""
    if ttd_override is not None:
        return uint256(ttd_override)
    return config.TERMINAL_TOTAL_DIFFICULTY


def apply_terminal_total_difficulty_override(ttd_override: uint256) -> None:
    """Apply the operator-supplied override to the runtime config, so every
    existing TERMINAL_TOTAL_DIFFICULTY consumer (is_valid_terminal_pow_block,
    validator.get_pow_block_at_terminal_total_difficulty) sees the
    overridden value — the reference's stated intent that the setting
    'takes precedence over the existing configuration'."""
    config.TERMINAL_TOTAL_DIFFICULTY = uint256(ttd_override)


def is_terminal_total_difficulty_overridden(ttd_override: Optional[uint256]) -> boolean:
    """Whether the node is running on an operator-supplied override —
    surfaced so operators and peers can tell a coordinated-override node
    from a default one. Decided by the setting alone, NOT by comparing
    against the runtime config: once applied, the override IS the config,
    and an override that happens to equal the shipped value is still a
    deliberate operator decision."""
    return boolean(ttd_override is not None)
