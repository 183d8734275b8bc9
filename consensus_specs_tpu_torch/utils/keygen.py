"""Exact key and signature derivation spread over spawned processes.

Building a mainnet-sized workload costs host time: ~1 ms a small-scalar
``SkToPk`` and ~25 ms a ``Sign`` (a pure-Python hash to G2 and a G2
multiply), so an epoch's 2,112 signatures or a million-validator slot's
32,768 pubkeys take tens of seconds in one process. ``KeyPool`` runs the
same oracle arithmetic as the switchboard's ``SkToPk`` and ``Sign`` in a
pool of ``spawn`` processes (no fork of a process holding a CUDA context)
and returns the same bytes, in order. Workers import only the oracle
module, not torch. With ``processes <= 1`` or BLS off it is the
switchboard itself.
"""
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

# items a worker task carries: big enough to amortize the pickling, small
# enough to spread an epoch's signatures over every worker
_CHUNK = 64


def _sk_to_pk_chunk(sks: Sequence[int]) -> List[bytes]:
    from .bls12_381 import G1_GEN, ec_mul, ec_to_affine, g1_to_bytes

    return [g1_to_bytes(ec_to_affine(ec_mul(G1_GEN, sk))) for sk in sks]


def _sign_chunk(pairs: Sequence[Tuple[int, bytes]], dst: bytes
                ) -> List[bytes]:
    from .bls12_381 import ec_mul, ec_to_affine, g2_to_bytes, hash_to_g2

    return [g2_to_bytes(ec_to_affine(ec_mul(hash_to_g2(msg, dst), sk)))
            for sk, msg in pairs]


def default_processes() -> int:
    return max(1, len(os.sched_getaffinity(0)))


class KeyPool:
    """Context manager over a spawn pool; ``sk_to_pk`` and ``sign`` give
    what ``[bls.SkToPk(sk) ...]`` and ``[bls.Sign(sk, m) ...]`` give."""

    def __init__(self, processes: Optional[int] = None):
        self.processes = (default_processes() if processes is None
                          else max(1, int(processes)))
        self._ex = None

    def __enter__(self):
        if self.processes > 1:
            self._ex = ProcessPoolExecutor(
                max_workers=self.processes,
                mp_context=multiprocessing.get_context("spawn"))
        return self

    def __exit__(self, *exc):
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._ex = None
        return False

    def _map(self, fn, items, sks, serial):
        # the switchboard is imported here, not with this module: it
        # imports torch, and every worker imports this module
        from . import bls

        if self._ex is None or not bls.bls_active or len(items) <= _CHUNK:
            return serial(items)
        if any(not 0 < sk < bls.R for sk in sks):
            raise ValueError("invalid secret key")
        chunks = [items[i:i + _CHUNK] for i in range(0, len(items), _CHUNK)]
        return [x for part in self._ex.map(fn, chunks) for x in part]

    def map(self, fn: Callable, items: Sequence) -> List:
        """``[fn(x) for x in items]``, spread over the pool's processes
        (``fn`` must be picklable: a module-level function). Serial with no
        pool."""
        if self._ex is None:
            return [fn(x) for x in items]
        return list(self._ex.map(fn, items))

    def sk_to_pk(self, sks: Sequence[int]) -> List[bytes]:
        from . import bls

        sks = [int(sk) for sk in sks]
        return self._map(_sk_to_pk_chunk, sks, sks,
                         lambda xs: [bls.SkToPk(sk) for sk in xs])

    def sign(self, pairs: Sequence[Tuple[int, bytes]]) -> List[bytes]:
        from . import bls

        pairs = [(int(sk), bytes(msg)) for sk, msg in pairs]
        return self._map(partial(_sign_chunk, dst=bls.DST), pairs,
                         [sk for sk, _ in pairs],
                         lambda xs: [bls.Sign(sk, m) for sk, m in xs])
