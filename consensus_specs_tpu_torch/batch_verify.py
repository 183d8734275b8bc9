"""Batched signature verification plane of the port: collect-then-verify
for block and attestation replay (the counterpart of
consensus_specs_tpu/batch_verify.py).

  with SignatureCollector(spec) as col:
      for block in blocks:
          spec.state_transition(state, block)   # signature checks RECORDED
  ok = col.flush()                              # ... and verified batched
  assert ok.all()

The spec comes from the caller: a built spec module whose global ``bls``
is its own switchboard. For the span of the context the collector points
``spec.bls`` at the port's switchboard (``utils/bls.py``), with its
interceptors installed there, and carries the ``bls_active`` flag of the
spec's own switchboard into the port's. On exit, an exception included,
it restores the spec's ``bls``, its wrapped functions and the port's flag
and functions. It never touches any other switchboard module. Without a
spec it patches the port's switchboard alone.

What is deferred vs eager, chosen by the spec's own failure semantics:

- DEFERRED (assert-style; a failure invalidates the whole span anyway):
  ``bls.FastAggregateVerify`` / ``bls.AggregateVerify`` (attestations,
  attester slashings, altair's ``eth_fast_aggregate_verify``), the block
  proposer signature (``verify_block_signature``), and ``bls.Verify``
  inside ``process_randao``, ``process_voluntary_exit`` and
  ``process_proposer_slashing`` (handler-scoped interception).
- EAGER: ``bls.Verify`` everywhere else, through the port's switchboard
  (the card by default; ``use_py_ecc()`` selects the CPU oracle), because
  ``process_deposit`` uses it CONDITIONALLY: an invalid deposit
  proof-of-possession skips the validator instead of failing the block.

``flush()`` runs the recorded checks through the port's batched entry
points on ``device`` (None is the CUDA card and raises without one;
``device="cpu"`` runs the plain PyTorch versions), grouped by
committee-size bucket so a lone 512-wide sync aggregate does not pad the
whole attestation batch. A backend error raises out of ``flush``: no
verdict is ever answered from the oracle instead.
"""
from typing import List, Sequence, Tuple

import numpy as np

from .ops.bls_backend import _k_bucket
from .utils import bls

_DEFERRING_HANDLERS = ("process_randao", "process_voluntary_exit",
                       "process_proposer_slashing")


class CollectedCheck:
    __slots__ = ("kind", "pubkeys", "messages", "signature")

    def __init__(self, kind: str, pubkeys, messages, signature):
        self.kind = kind  # "fast_aggregate" | "aggregate"
        self.pubkeys = pubkeys
        # one message (fast_aggregate) or a per-key list (aggregate)
        self.messages = messages
        self.signature = signature


class SignatureCollector:
    """Context manager recording the spec's assert-style BLS verifications,
    answering True during collection; ``flush()`` verifies them batched."""

    def __init__(self, spec=None):
        self.spec = spec
        self.checks: List[CollectedCheck] = []
        # the eager bls.Verify, refreshed on entry (another collector may
        # have wrapped it)
        self._orig_verify = bls.Verify
        self._saved_bls: Tuple = ()
        self._saved_flag = None
        self._saved_spec_bls = None
        self._saved_vbs = None
        self._saved_handlers: List = []
        # True only inside the assert-style handlers: their bls.Verify
        # calls are safe to defer, unlike process_deposit's
        self._defer_verify = False

    # -- switchboard interception ------------------------------------------

    def _fast_aggregate_verify(self, pubkeys, message, signature):
        if not bls.bls_active:
            # stub mode: blocks carry stub signatures that must NOT reach
            # real crypto at flush time; only_with_bls's answer, no record
            return True
        if len(pubkeys) == 0:
            # the reference returns False without any crypto
            return False
        self.checks.append(
            CollectedCheck(
                "fast_aggregate",
                [bytes(pk) for pk in pubkeys],
                bytes(message),
                bytes(signature),
            )
        )
        return True

    def _aggregate_verify(self, pubkeys, messages, signature):
        if not bls.bls_active:
            return True
        if len(pubkeys) == 0 or len(pubkeys) != len(messages):
            return False
        self.checks.append(
            CollectedCheck(
                "aggregate",
                [bytes(pk) for pk in pubkeys],
                [bytes(m) for m in messages],
                bytes(signature),
            )
        )
        return True

    def _verify_block_signature(self, state, signed_block):
        if not bls.bls_active:
            return True
        spec = self.spec
        proposer = state.validators[signed_block.message.proposer_index]
        signing_root = spec.compute_signing_root(
            signed_block.message,
            spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER),
        )
        self.checks.append(
            CollectedCheck(
                "fast_aggregate",
                [bytes(proposer.pubkey)],
                bytes(signing_root),
                bytes(signed_block.signature),
            )
        )
        return True

    def _verify(self, pubkey, message, signature):
        """bls.Verify interceptor: deferred only inside the assert-style
        handlers; everywhere else (deposits included) the switchboard's
        own Verify answers eagerly."""
        if not self._defer_verify:
            return self._orig_verify(pubkey, message, signature)
        if not bls.bls_active:
            return True
        self.checks.append(
            CollectedCheck(
                "fast_aggregate", [bytes(pubkey)], bytes(message),
                bytes(signature)
            )
        )
        return True

    def _deferring(self, handler):
        """Wrap a spec handler so bls.Verify defers for its duration."""
        def wrapped(*args, **kwargs):
            was = self._defer_verify
            self._defer_verify = True
            try:
                return handler(*args, **kwargs)
            finally:
                self._defer_verify = was

        return wrapped

    def __enter__(self):
        spec = self.spec
        self._orig_verify = bls.Verify
        self._saved_bls = (bls.FastAggregateVerify, bls.AggregateVerify,
                           self._orig_verify)
        self._saved_flag = bls.bls_active
        if spec is not None:
            self._saved_spec_bls = getattr(spec, "bls", None)
            if self._saved_spec_bls is not None:
                bls.bls_active = getattr(self._saved_spec_bls, "bls_active",
                                         bls.bls_active)
            spec.bls = bls
        bls.FastAggregateVerify = self._fast_aggregate_verify
        bls.AggregateVerify = self._aggregate_verify
        bls.Verify = self._verify
        if spec is not None and hasattr(spec, "verify_block_signature"):
            self._saved_vbs = spec.verify_block_signature
            spec.verify_block_signature = self._verify_block_signature
        if spec is not None:
            for name in _DEFERRING_HANDLERS:
                handler = getattr(spec, name, None)
                if handler is not None:
                    self._saved_handlers.append((name, handler))
                    setattr(spec, name, self._deferring(handler))
        return self

    def __exit__(self, *exc):
        bls.FastAggregateVerify, bls.AggregateVerify, bls.Verify = \
            self._saved_bls
        bls.bls_active = self._saved_flag
        spec = self.spec
        if self._saved_vbs is not None:
            spec.verify_block_signature = self._saved_vbs
            self._saved_vbs = None
        for name, handler in self._saved_handlers:
            setattr(spec, name, handler)
        self._saved_handlers = []
        if spec is not None:
            if self._saved_spec_bls is None:
                vars(spec).pop("bls", None)
            else:
                spec.bls = self._saved_spec_bls
            self._saved_spec_bls = None
        return False

    # -- batched resolution -------------------------------------------------

    def _unique_checks(self) -> Tuple[List[int], List[List[int]]]:
        """Dedup identical recorded checks: the same attestation included
        in multiple blocks is one verification, fanned out to every
        occurrence. Returns (first-occurrence indices in record order,
        per-unique member index lists)."""
        order: List[int] = []
        members: List[List[int]] = []
        seen = {}
        for i, c in enumerate(self.checks):
            key = _dedup_key(c)
            u = seen.get(key)
            if u is None:
                seen[key] = len(order)
                order.append(i)
                members.append([i])
            else:
                members[u].append(i)
        return order, members

    def flush(self, backend=None, device=None, service=None,
              rlc: bool = False) -> np.ndarray:
        """Verify all recorded checks; returns a bool array in record order.

        Identical checks (same kind/pubkeys/message(s)/signature) are
        verified ONCE and the result fanned out to every occurrence.

        With ``service`` (a port ``serve.VerificationService``), the unique
        checks ride the streaming plane: micro-batched with whatever else
        the service carries, cached, deduped against other submitters.
        Otherwise checks are grouped by (kind, K-bucket) so each batch pads
        to its own committee-size bucket, on ``device`` (None is the card).

        ``rlc=True`` resolves the whole span through ``batch_verify_rlc``:
        ONE final exponentiation for all recorded checks instead of one per
        check, with bisection recovering exact per-item verdicts."""
        out = np.zeros(len(self.checks), dtype=bool)
        order, members = self._unique_checks()

        if service is not None:
            if backend is not None or device is not None:
                raise ValueError(
                    "flush(service=...) uses the service's own backend and "
                    "device; pass backend/device to the VerificationService "
                    "instead"
                )
            if rlc:
                raise ValueError(
                    "flush(service=..., rlc=True): the service routes its "
                    "micro-batches through the RLC path itself "
                    "(CONSENSUS_SPECS_TPU_RLC governs it)"
                )
            futures = [
                service.submit(c.kind, c.pubkeys, c.messages, c.signature)
                for c in (self.checks[i] for i in order)
            ]
            for m, fut in zip(members, futures):
                out[m] = bool(fut.result())
            return out

        if backend is None:
            from .ops import bls_backend as backend  # noqa: F811

        if rlc:
            checks = [self.checks[i] for i in order]
            res = backend.batch_verify_rlc(
                [(c.kind, c.pubkeys, c.messages, c.signature)
                 for c in checks],
                device=device,
            )
            for u, r in enumerate(res):
                out[members[u]] = bool(r)
            return out

        groups = {}
        for u, i in enumerate(order):
            c = self.checks[i]
            key = (c.kind, _bucket_of(len(c.pubkeys)))
            groups.setdefault(key, []).append(u)

        for (kind, _bucket), uidxs in groups.items():
            checks = [self.checks[order[u]] for u in uidxs]
            batch = (backend.batch_fast_aggregate_verify
                     if kind == "fast_aggregate"
                     else backend.batch_aggregate_verify)
            res = batch(
                [c.pubkeys for c in checks],
                [c.messages for c in checks],
                [c.signature for c in checks],
                device=device,
            )
            for r, u in zip(res, uidxs):
                out[members[u]] = bool(r)
        return out

    def flush_oracle(self) -> np.ndarray:
        """Sequential pure-Python resolution of the same checks (the
        reference's execution model): the cross-check for flush(). Calls
        the switchboard's oracle functions, whatever its backend switch
        says."""
        out = np.zeros(len(self.checks), dtype=bool)
        for i, c in enumerate(self.checks):
            if c.kind == "fast_aggregate":
                out[i] = bls.oracle_fast_aggregate_verify(
                    c.pubkeys, c.messages, c.signature)
            else:
                out[i] = bls.oracle_aggregate_verify(
                    c.pubkeys, c.messages, c.signature)
        return out


def _bucket_of(k: int) -> int:
    return _k_bucket(max(1, k))


def _dedup_key(c: CollectedCheck):
    msgs = c.messages if isinstance(c.messages, bytes) else tuple(c.messages)
    return (c.kind, tuple(c.pubkeys), msgs, c.signature)


def replay_blocks_batched(spec, state, signed_blocks: Sequence,
                          device=None) -> np.ndarray:
    """Replay ``signed_blocks`` through ``spec.state_transition`` with all
    assert-style signature checks collected, then batch-verified on
    ``device``. Mutates ``state``. Returns the per-check result array (all
    True = valid span)."""
    with SignatureCollector(spec) as col:
        for signed_block in signed_blocks:
            spec.state_transition(state, signed_block)
    return col.flush(device=device)


def feed_attestations_batched(spec, store, attestations: Sequence,
                              device=None) -> np.ndarray:
    """Feed wire attestations to fork-choice ``on_attestation`` with their
    FastAggregateVerify checks collected, then batch-verified on
    ``device``. Store mutations happen optimistically during collection;
    a False in the result means the span must be re-fed per call against
    a fresh store (the reference's always-sequential path)."""
    with SignatureCollector(spec) as col:
        for attestation in attestations:
            spec.on_attestation(store, attestation)
    return col.flush(device=device)


def feed_attestations_streamed(spec, store, attestations, service=None,
                               device=None) -> np.ndarray:
    """Streaming twin of ``feed_attestations_batched``: attestations come
    from an ITERATOR (a live gossip feed), and each recorded check is
    submitted to the serve plane the moment it is recorded, so
    verification overlaps ingestion and duplicates across the stream are
    verified once by the service's cache and dedup.

    With ``service=None`` a private port ``VerificationService(device=)``
    is created for the call (before the collector context, so its oracle
    rung captures the real switchboard functions) and closed afterwards.
    Returns the per-check bool array in record order."""
    owned = service is None
    if owned:
        from .serve import VerificationService

        service = VerificationService(device=device)
    elif device is not None:
        raise ValueError(
            "feed_attestations_streamed(service=...) uses the service's own "
            "device; pass device to the VerificationService instead")
    futures = []
    try:
        with SignatureCollector(spec) as col:
            n_seen = 0
            for attestation in attestations:
                spec.on_attestation(store, attestation)
                for c in col.checks[n_seen:]:
                    futures.append(
                        service.submit(c.kind, c.pubkeys, c.messages,
                                       c.signature)
                    )
                n_seen = len(col.checks)
        return np.array([bool(f.result()) for f in futures], dtype=bool)
    finally:
        if owned:
            service.close()
