"""Spec builder of the port (its copy of consensus_specs_tpu/builder.py):
binds (fork, preset, config) into importable spec modules.

The reference compiles markdown specs into flat Python modules per
(fork, preset) with forks layered by dict-merge override
(reference: setup.py:163-259 parse, :722-745 combine, :561-659 emit).

Here the spec sources are authored Python (`specsrc/<fork>/*.py`) and the same
layering model is kept: sources of each fork in the lineage are exec'd in order
into ONE module namespace, so later forks override earlier definitions exactly
like `combine_spec_objects`, and all functions resolve names (containers,
helpers, `config`) late — seeing the final fork's overrides.

Built modules are registered as `consensus_specs_tpu_torch.<fork>.<preset>`,
never under the JAX package's names, so both packages' specs live side by
side in one process, and a `spec_targets` map mirrors the reference
harness's (reference: tests/core/pyspec/eth2spec/test/context.py:53-64).
The prelude binds `bls` to the port's switchboard (`utils/bls.py`, the card
by default) and SSZ, hashing and config to the port's own copies.
"""
import collections
import copy
import functools
import sys
import threading
import types
from pathlib import Path
from typing import Any, Dict

from .config.config_util import load_defaults, load_preset_for_fork

SPEC_SRC_DIR = Path(__file__).resolve().parent / "specsrc"

FORK_ORDER = ["phase0", "altair", "merge", "sharding", "custody_game"]

# every fork the JAX package builds: sharding and custody_game are draft
# forks the reference does not compile (reference test/context.py:398-399);
# sharding's sources run on the port's own KZG plane (utils/kzg.py)
IMPLEMENTED_FORKS = ["phase0", "altair", "merge", "sharding", "custody_game"]

SOURCES = {
    "phase0": [
        "beacon_chain.py",
        "fork_choice.py",
        "validator.py",
        "p2p.py",
        "weak_subjectivity.py",
    ],
    "altair": [
        "bls.py",
        "beacon_chain.py",
        "fork.py",
        "sync_protocol.py",
        "validator.py",
        "p2p.py",
    ],
    "merge": [
        "beacon_chain.py",
        "fork_choice.py",
        "fork.py",
        "validator.py",
        "p2p.py",
        "client_settings.py",
    ],
    "sharding": [
        "beacon_chain.py",
        "p2p.py",
    ],
    "custody_game": [
        "beacon_chain.py",
        "validator.py",
    ],
}

# runtime-config vars that are NOT plain uint64
_CONFIG_BYTES_VARS = {
    "TERMINAL_BLOCK_HASH": "Hash32",
    "GENESIS_FORK_VERSION": "Version",
    "ALTAIR_FORK_VERSION": "Version",
    "MERGE_FORK_VERSION": "Version",
    "SHARDING_FORK_VERSION": "Version",
}


class Configuration:
    """Mutable runtime-config object; the reference generates a NamedTuple +
    a module-global `config` whose fields tests swap
    (reference: setup.py:600-620, test/context.py:422-458)."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    def __repr__(self):
        return f"Configuration({self.__dict__!r})"

    def copy(self):
        return Configuration(**self.__dict__)


def _typed_config(raw: Dict[str, Any], ns: Dict[str, Any]) -> Configuration:
    from .utils.ssz.ssz_typing import uint64, uint256

    out = {}
    for k, v in raw.items():
        if k == "PRESET_BASE":
            out[k] = v
        elif k in _CONFIG_BYTES_VARS:
            out[k] = ns[_CONFIG_BYTES_VARS[k]](v)
        elif k == "DEPOSIT_CONTRACT_ADDRESS":
            out[k] = ns["Bytes20"](v)
        elif k == "TERMINAL_TOTAL_DIFFICULTY":
            out[k] = uint256(v)
        elif isinstance(v, int):
            out[k] = uint64(v)
        else:
            out[k] = v
    return Configuration(**out)


def _install_prelude(ns: Dict[str, Any], preset_name: str, fork: str) -> None:
    """The runtime every spec source compiles against: SSZ algebra, crypto,
    custom types, preset constants, runtime config."""
    import dataclasses
    from dataclasses import dataclass, field
    from typing import (  # noqa: F401
        Any, Callable, Dict, Optional, Sequence, Set, Tuple,
    )

    from .utils import bls
    from .utils.hash_function import hash as _hash
    from .utils.ssz import ssz_typing as tz
    from .utils.ssz.gindex import GeneralizedIndex, get_generalized_index
    from .utils.ssz.ssz_impl import copy, hash_tree_root, serialize, uint_to_bytes

    def ceillog2(x: int) -> tz.uint64:
        if x < 1:
            raise ValueError(f"ceillog2 accepts only positive values, x={x}")
        return tz.uint64((x - 1).bit_length())

    def floorlog2(x: int) -> tz.uint64:
        if x < 1:
            raise ValueError(f"floorlog2 accepts only positive values, x={x}")
        return tz.uint64(x.bit_length() - 1)

    ns.update(
        dict(
            # typing / dataclasses
            Any=Any, Callable=Callable, Dict=Dict, Optional=Optional,
            Sequence=Sequence, Set=Set, Tuple=Tuple,
            dataclass=dataclass, field=field, dataclasses=dataclasses,
            # SSZ algebra
            boolean=tz.boolean, uint8=tz.uint8, uint16=tz.uint16,
            uint32=tz.uint32, uint64=tz.uint64, uint128=tz.uint128,
            uint256=tz.uint256, byte=tz.uint8,
            Container=tz.Container, Vector=tz.Vector, List=tz.List,
            Bitvector=tz.Bitvector, Bitlist=tz.Bitlist,
            ByteVector=tz.ByteVector, ByteList=tz.ByteList, Union=tz.Union,
            Bytes1=tz.Bytes1, Bytes4=tz.Bytes4, Bytes8=tz.Bytes8,
            Bytes20=tz.Bytes20, Bytes32=tz.Bytes32, Bytes48=tz.Bytes48,
            Bytes96=tz.Bytes96,
            # crypto / ssz impl
            bls=bls, hash=_hash, hash_tree_root=hash_tree_root,
            serialize=serialize, copy=copy, uint_to_bytes=uint_to_bytes,
            # merkle-proof algebra (reference setup.py:46-57, :466-472)
            GeneralizedIndex=GeneralizedIndex,
            get_generalized_index=get_generalized_index,
            ceillog2=ceillog2, floorlog2=floorlog2,
        )
    )

    # custom types (reference specs/phase0/beacon-chain.md:152-171)
    class Slot(tz.uint64):
        pass

    class Epoch(tz.uint64):
        pass

    class CommitteeIndex(tz.uint64):
        pass

    class ValidatorIndex(tz.uint64):
        pass

    class Gwei(tz.uint64):
        pass

    class Root(tz.Bytes32):
        pass

    class Hash32(tz.Bytes32):
        pass

    class Version(tz.Bytes4):
        pass

    class DomainType(tz.Bytes4):
        pass

    class ForkDigest(tz.Bytes4):
        pass

    class Domain(tz.Bytes32):
        pass

    class BLSPubkey(tz.Bytes48):
        pass

    class BLSSignature(tz.Bytes96):
        pass

    ns.update(
        Slot=Slot, Epoch=Epoch, CommitteeIndex=CommitteeIndex,
        ValidatorIndex=ValidatorIndex, Gwei=Gwei, Root=Root, Hash32=Hash32,
        Version=Version, DomainType=DomainType, ForkDigest=ForkDigest,
        Domain=Domain, BLSPubkey=BLSPubkey, BLSSignature=BLSSignature,
    )

    # preset vars, typed uint64 (reference setup.py:763-778)
    preset = load_preset_for_fork(preset_name, fork)
    for k, v in preset.items():
        ns[k] = tz.uint64(v) if isinstance(v, int) else v

    # runtime config (reference setup.py:600-620)
    ns["config"] = _typed_config(load_defaults(preset_name), ns)


def _cache_this(key_fn, value_fn, lru_size):
    """``value_fn`` memoized on ``key_fn`` of the same arguments in an LRU of
    ``lru_size`` entries (reference: setup.py:365-380). A list or set
    result is handed out as a shallow copy, so a caller that mutates it
    never reaches the cache; the lock keeps the LRU whole under the
    serve and chain planes' threads."""
    cache = collections.OrderedDict()
    lock = threading.Lock()

    def wrapper(*args, **kw):
        key = key_fn(*args, **kw)
        with lock:
            hit = key in cache
            if hit:
                cache.move_to_end(key)
                value = cache[key]
        if not hit:
            value = value_fn(*args, **kw)
            with lock:
                cache[key] = value
                if len(cache) > lru_size:
                    cache.popitem(last=False)
        return copy.copy(value) if isinstance(value, (list, set)) else value

    wrapper.__name__ = value_fn.__name__
    wrapper.__wrapped_raw__ = value_fn
    return wrapper


def _state_accessor_caches(ns: Dict[str, Any]) -> Dict[str, tuple]:
    """Four of the reference's accessor caches (setup.py:382-423), each
    keyed on every part of the state its function reads: the registry's
    root (the validators' balances, activation and exit epochs), the RANDAO
    mixes' root where a seed is read, and the epoch or slot. A warm
    registry root still scans every validator's mutation stamp (O(n),
    utils/ssz/ssz_typing.py), so only accessors that cost more than that
    scan are cached: not ``get_base_reward``, whose own cost is one cached
    ``get_total_active_balance``."""
    def epoch_of(state):
        return int(ns["compute_epoch_at_slot"](state.slot))

    def registry(state):
        return bytes(state.validators.hash_tree_root())

    slots = int(ns["SLOTS_PER_EPOCH"])
    return {
        "get_total_active_balance": (
            lambda state: (registry(state), epoch_of(state)), 10),
        "get_committee_count_per_slot": (
            lambda state, epoch: (registry(state), int(epoch)), slots * 3),
        "get_active_validator_indices": (
            lambda state, epoch: (registry(state), int(epoch)), 3),
        "get_beacon_committee": (
            lambda state, slot, index: (
                registry(state), bytes(state.randao_mixes.hash_tree_root()),
                int(slot), int(index)),
            slots * int(ns["MAX_COMMITTEES_PER_SLOT"]) * 3),
    }


def _apply_optimizations(ns: Dict[str, Any]) -> None:
    """Memoize the pure shuffling kernel and the state accessors the spec
    calls over and over (the committees, the active set, the total active
    balance) — the reference injects these LRU caches at spec-build time
    (reference: setup.py:365-423). Every cache is keyed on what its
    function reads, so the spec's results are unchanged."""
    if "compute_shuffled_index" in ns:
        raw = ns["compute_shuffled_index"]
        cached = functools.lru_cache(maxsize=1 << 20)(raw)
        cached.__wrapped_raw__ = raw
        ns["compute_shuffled_index"] = cached
    for name, (key_fn, lru_size) in _state_accessor_caches(ns).items():
        if name in ns:
            ns[name] = _cache_this(key_fn, ns[name], lru_size)
    # eth_aggregate_pubkeys fast path: swap in bls.AggregatePKs, keeping the
    # spec-text version available (reference setup.py:60-63, 484-487)
    if "eth_aggregate_pubkeys" in ns:
        from .utils import bls as _bls

        spec_version = ns["eth_aggregate_pubkeys"]
        BLSPubkey = ns["BLSPubkey"]

        def eth_aggregate_pubkeys(pubkeys):
            if not _bls.bls_active:
                return spec_version(pubkeys)
            assert len(pubkeys) > 0
            return BLSPubkey(_bls.AggregatePKs(list(pubkeys)))

        ns["_eth_aggregate_pubkeys_spec"] = spec_version
        ns["eth_aggregate_pubkeys"] = eth_aggregate_pubkeys


_built: Dict[tuple, types.ModuleType] = {}


def build_spec_module(fork: str, preset_name: str) -> types.ModuleType:
    key = (fork, preset_name)
    if key in _built:
        return _built[key]
    if fork not in FORK_ORDER:
        raise ValueError(f"unknown fork {fork!r}")
    if fork not in IMPLEMENTED_FORKS:
        # never hand back a silently mis-layered module for a fork whose
        # sources don't exist yet
        raise NotImplementedError(
            f"fork {fork!r} has no spec sources (implemented: {IMPLEMENTED_FORKS})"
        )
    mod_name = f"consensus_specs_tpu_torch.{fork}.{preset_name}"
    module = types.ModuleType(mod_name)
    ns = module.__dict__
    _install_prelude(ns, preset_name, fork)
    lineage = FORK_ORDER[: FORK_ORDER.index(fork) + 1]
    # previous-fork modules bound FIRST: spec sources reference them in
    # eagerly-evaluated annotations (e.g. `pre: phase0.BeaconState`,
    # reference specs/altair/fork.md:62) as well as in function bodies
    for prev in lineage[:-1]:
        ns[prev] = build_spec_module(prev, preset_name)
    for fk in lineage:
        for src in SOURCES[fk]:
            path = SPEC_SRC_DIR / fk / src
            if not path.exists():
                # a missing source for an implemented fork is a build error,
                # not a skip — silent skipping shipped a broken altair once
                raise FileNotFoundError(
                    f"spec source missing for implemented fork {fk!r}: {path}"
                )
            code = compile(path.read_text(), str(path), "exec")
            exec(code, ns)
    module.fork = fork
    module.preset_base = preset_name
    _apply_optimizations(ns)
    _built[key] = module
    sys.modules[mod_name] = module
    return module


def spec_targets() -> Dict[str, Dict[str, types.ModuleType]]:
    """{preset: {fork: module}} map, built lazily on access
    (reference: test/context.py:53-64)."""
    out: Dict[str, Dict[str, types.ModuleType]] = {}
    for preset in ("minimal", "mainnet"):
        out[preset] = {}
        for fork in IMPLEMENTED_FORKS:
            out[preset][fork] = build_spec_module(fork, preset)
    return out
