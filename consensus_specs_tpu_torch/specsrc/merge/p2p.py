# The Merge — P2P networking interface: the executable artifacts
#
# The computable parts of reference specs/merge/p2p-interface.md. The merge
# changes no wire sizes and adds no containers; what changes is TYPE
# SELECTION and gossip VALIDATION once blocks carry an ExecutionPayload:
#
# - the `beacon_block` topic's payload becomes the merge SignedBeaconBlock,
#   and gossip validation adds an executable predicate — the payload
#   timestamp must match the slot (p2p-interface.md "beacon_block" [REJECT]
#   conditions);
# - Req/Resp BeaconBlocksByRange/ByRoot move to /2 protocol IDs whose
#   response chunks are CONTEXT-dependent: a 4-byte fork digest prefix
#   selects the SSZ type of each chunk (p2p-interface.md "Req/Resp" —
#   `context = compute_fork_digest(...)`), computed here per epoch.
#
# The transport itself stays specified-not-executed (SURVEY.md §2.7/P5),
# exactly like the phase0/altair p2p modules before this one.


def compute_fork_version(epoch: Epoch) -> Version:
    """The fork version active at ``epoch`` — the merge lineage's
    version-schedule lookup backing every context-bytes computation
    (p2p-interface.md Req/Resp fork-digest context table)."""
    if epoch >= config.MERGE_FORK_EPOCH:
        return config.MERGE_FORK_VERSION
    if epoch >= config.ALTAIR_FORK_EPOCH:
        return config.ALTAIR_FORK_VERSION
    return config.GENESIS_FORK_VERSION


def compute_block_context_bytes(epoch: Epoch, genesis_validators_root: Root) -> ForkDigest:
    """Context bytes prefixing every BeaconBlocksByRange/ByRoot v2 response
    chunk: the fork digest of the version at the BLOCK's epoch, which is
    what tells the requester whether the chunk decodes as a phase0, altair
    or merge SignedBeaconBlock (p2p-interface.md Req/Resp v2)."""
    return compute_fork_digest(compute_fork_version(epoch), genesis_validators_root)


def block_response_fork(epoch: Epoch) -> str:
    """Which fork's SignedBeaconBlock type a v2 block response chunk at
    ``epoch`` carries — the type-selection rule the context bytes encode."""
    if epoch >= config.MERGE_FORK_EPOCH:
        return 'merge'
    if epoch >= config.ALTAIR_FORK_EPOCH:
        return 'altair'
    return 'phase0'


def validate_beacon_block_gossip_payload(state: BeaconState, block: BeaconBlock) -> None:
    """The merge's executable addition to `beacon_block` gossip validation:
    if the block carries a (transition-enabled) execution payload, its
    timestamp MUST equal the slot's timestamp — a [REJECT] condition, so
    an assert here, matching the on-chain process_execution_payload check
    (p2p-interface.md "beacon_block"; beacon-chain.md:process_execution_payload)."""
    if is_execution_enabled(state, block.body):
        assert block.body.execution_payload.timestamp == compute_timestamp_at_slot(state, block.slot)
