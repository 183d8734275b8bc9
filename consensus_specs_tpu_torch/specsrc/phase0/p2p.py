# Phase 0 — P2P networking interface: the executable artifacts
#
# The reference's p2p spec (specs/phase0/p2p-interface.md) is protocol text;
# its *computable* parts are these constants, SSZ message containers, and pure
# functions. The gossip/reqresp transport itself is specified, not executed
# (SURVEY.md section 2.7/P5).

# Network configuration (p2p-interface.md:168-184)
GOSSIP_MAX_SIZE = 2**20  # 1 MiB
MAX_REQUEST_BLOCKS = 2**10
EPOCHS_PER_SUBNET_SUBSCRIPTION = 2**8
MIN_EPOCHS_FOR_BLOCK_REQUESTS = 33024  # MIN_VALIDATOR_WITHDRAWABILITY_DELAY + CHURN_LIMIT_QUOTIENT / 2
MAX_CHUNK_SIZE = 2**20  # 1 MiB
TTFB_TIMEOUT = 5  # seconds
RESP_TIMEOUT = 10  # seconds
ATTESTATION_PROPAGATION_SLOT_RANGE = 32
MAXIMUM_GOSSIP_CLOCK_DISPARITY = 500  # milliseconds

# Message-id domains for gossipsub (p2p-interface.md:206-291)
MESSAGE_DOMAIN_INVALID_SNAPPY = DomainType(b'\x00\x00\x00\x00')
MESSAGE_DOMAIN_VALID_SNAPPY = DomainType(b'\x01\x00\x00\x00')


class MetaData(Container):
    # (p2p-interface.md:185-205)
    seq_number: uint64
    attnets: Bitvector[ATTESTATION_SUBNET_COUNT]


class Status(Container):
    # Req/Resp Status message (p2p-interface.md:649-694)
    fork_digest: ForkDigest
    finalized_root: Root
    finalized_epoch: Epoch
    head_root: Root
    head_slot: Slot


class ENRForkID(Container):
    # discv5 eth2 ENR entry (p2p-interface.md:887-975)
    fork_digest: ForkDigest
    next_fork_version: Version
    next_fork_epoch: Epoch


def compute_gossip_message_id(message_data: bytes, valid_snappy_decompressed: bytes = None) -> bytes:
    """Gossipsub message-id: SHA256(domain + payload)[:20]
    (p2p-interface.md:242-253)."""
    if valid_snappy_decompressed is not None:
        return hash(MESSAGE_DOMAIN_VALID_SNAPPY + valid_snappy_decompressed)[:20]
    return hash(MESSAGE_DOMAIN_INVALID_SNAPPY + message_data)[:20]
