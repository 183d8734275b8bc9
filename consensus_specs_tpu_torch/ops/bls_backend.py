"""Batched BLS aggregate-signature verification on the CUDA card: the
verify subset of consensus_specs_tpu/ops/bls_backend.py.

Pipeline (the same as the JAX package's, with the same programs):

  PREP  decode / KeyValidate pubkeys, decode + subgroup-check signatures,
        hash messages to G2 for every cache miss at once through the
        batched input codec (ops/codec.py: on the card, its field
        functions on the Montgomery kernel and its subgroup and
        hash-finish programs on the step kernel; on the CPU, raw-int host
        math); the Montgomery limb encodings cached. With
        CONSENSUS_SPECS_TPU_BATCH_CODEC=0 each miss is prepared per item
        by the exact-int oracle (utils/bls12_381.py) instead.
  PROG A (device) aggregate K projective pubkeys + both Miller loops
        -> f, agg_Z (vmlib miller_product / aggregate_verify).
  HOST  easy part of the final exponentiation (one exact Fq12 inversion +
        Frobenius), serially.
  PROG B (device) hard part -> res (vmlib hard_part_frobenius / hard_part).
  HOST  res == 1, AND precheck AND agg != infinity.

``batch_verify_rlc`` shares PROG A and then decides the whole batch with
ONE combined check: the ``rlc_combine`` program (or the tower combine,
ops/pairing.rlc_combine) folds prod f_i^{r_i}, and one easy part + one
hard part judge it; a failed check bisects.

Every device stage is one ``vm.execute``, which on the card runs each VM
step through the fused CUDA step kernel. A verification whose host prep
fails (bad encoding, subgroup failure, infinity pubkey) is False without
touching the device.

Entry points take ``device=None`` (the CUDA card; raises without one) or
``device="cpu"`` (the plain PyTorch steps).

The planes read the counters here (``CALL_COUNTS``, ``PREP_STATS``,
``RLC_STATS``, bumped under one lock since a service's prep and device
threads both call in), the ``bls.*`` gauges of ``ops/profiling`` and the
``vm`` notes of the flight recorder (``obs/flight.py``).
"""
import functools
import hashlib
import os
import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import flight
from ..obs import programs as obs_programs
from ..utils import bls12_381 as O
from ..utils.bls12_381 import P
from . import fq, profiling, vm, vmlib

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# VM shape (the JAX package's): lane widths of the two ALU units, step
# count padding, committee-size buckets. 160 covers the mainnet committee
# (~146 members at 300k validators) without padding to 256.
W_MUL = 96
W_LIN = 192
PAD_STEPS = 256
_K_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 160, 256, 512, 1024, 2048]

_VM_CACHE_VERSION = 1

# guards every read-modify-write of CALL_COUNTS, PREP_STATS and RLC_STATS
_STATS_LOCK = threading.Lock()


def _bump(stats: Dict[str, int], **deltas) -> None:
    with _STATS_LOCK:
        for k, n in deltas.items():
            stats[k] += n


def _k_bucket(k: int) -> int:
    for b in _K_BUCKETS:
        if k <= b:
            return b
    raise ValueError(f"committee size {k} exceeds max bucket {_K_BUCKETS[-1]}")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b <<= 1
    return b


def _fold_for(kind: str, k: int, n_items: int = 1 << 30) -> int:
    """Items folded per program row (lane folding): enough to saturate
    the lanes, capped so the register file stays modest for wide-committee
    buckets, and never more than the batch itself."""
    if kind == "hard_part":
        table = 32
    elif kind in ("hard_part_windowed", "hard_part_frobenius"):
        table = 8
    elif kind == "rlc_combine":
        table = max(1, 16 // max(1, k))
    elif kind in ("g1_subgroup", "h2g_finish"):
        table = 4
    elif kind == "g2_subgroup":
        table = 8
    elif k <= 160:
        table = 8
    elif k <= 256:
        table = 4
    elif k <= 512:
        table = 2
    else:
        table = 1
    return min(table, _pow2_floor(max(1, n_items)))


def _vm_cache_dir() -> str:
    """Port-owned program cache beside the package (gitignored). It never
    reads the JAX package's .vm_cache: those pickles hold the JAX
    package's Program class."""
    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        ".vm_cache_torch",
    )
    os.makedirs(d, exist_ok=True)
    return d


@functools.lru_cache(maxsize=1)
def _program_fingerprint() -> str:
    """Hash of the sources an assembled program depends on (the assembler,
    the limb layout, the builders): any edit re-keys the whole cache."""
    h = hashlib.sha256()
    for mod in (vm, fq, vmlib):
        with open(mod.__file__, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:10]


@functools.lru_cache(maxsize=None)
def _program(kind: str, k: int = 0, fold: int = None) -> Tuple[vm.Program, int]:
    """Assembled program + its fold factor, disk-cached per program in
    ``.vm_cache_torch/`` (only pickles this code wrote are read back)."""
    if fold is None:
        fold = _fold_for(kind, k)
    builder = vmlib.BUILDERS.get(kind)
    if builder is None:
        raise ValueError(kind)
    t0 = time.perf_counter()
    path = os.path.join(
        _vm_cache_dir(),
        f"v{_VM_CACHE_VERSION}_{_program_fingerprint()}_{kind}_k{k}_f{fold}"
        f"_w{W_MUL}x{W_LIN}_p{PAD_STEPS}.pkl",
    )
    try:
        with open(path, "rb") as fh:
            loaded = pickle.load(fh)
        if isinstance(loaded, vm.Program):
            _note_program(kind, k, fold, loaded, time.perf_counter() - t0,
                          disk_hit=True)
            return loaded, fold
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError):
        pass  # absent or unreadable entry: assemble below
    assembled = builder(k, fold).assemble(
        w_mul=W_MUL, w_lin=W_LIN, pad_steps_to=PAD_STEPS,
        pad_regs_to=_pow2(64),
    )
    # per thread: a service's two stages may assemble the same program
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            pickle.dump(assembled, fh)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimization only
    _note_program(kind, k, fold, assembled, time.perf_counter() - t0,
                  disk_hit=False)
    return assembled, fold


def _note_program(kind: str, k: int, fold: int, assembled, seconds: float,
                  disk_hit: bool) -> None:
    """Feed the per-program registry (obs/programs.py) and the flight
    journal, once per (kind, k, fold) a process (the lru_cache on _program
    absorbs repeats); an assembly paid inline for a second or more is an
    ``assembly_stall``."""
    key = f"{kind}[k={k},fold={fold}]"
    obs_programs.note_assembly(key, n_steps=assembled.n_steps,
                               n_regs=assembled.n_regs, seconds=seconds,
                               disk_cache_hit=disk_hit)
    flight.note("vm", "program_resolved", key=key,
                cache="hit" if disk_hit else "miss",
                seconds=round(seconds, 4))
    if not disk_hit and seconds >= 1.0:
        flight.note("vm", "assembly_stall", key=key,
                    seconds=round(seconds, 4), steps=int(assembled.n_steps))


# ---------------------------------------------------------------------------
# host-side codecs (cached limb encodings)
# ---------------------------------------------------------------------------

_INF_G1 = (
    fq.to_mont_int(0),
    fq.to_mont_int(1),
    fq.to_mont_int(0),
)  # projective infinity (0:1:0)
_ONE_LIMBS = fq.to_mont_int(1)

# G2 generator limbs, stacked (x.0, x.1, y.0, y.1) x L — filler for
# inactive batch lanes
_G2GEN = O.ec_to_affine(O.G2_GEN)
_G2GEN_LIMBS = np.stack(
    [
        fq.to_mont_int(_G2GEN[0].c0),
        fq.to_mont_int(_G2GEN[0].c1),
        fq.to_mont_int(_G2GEN[1].c0),
        fq.to_mont_int(_G2GEN[1].c1),
    ]
)

_G2_COMPS = ("x.0", "x.1", "y.0", "y.1")

_SIG_CACHE: Dict[bytes, object] = {}
_MSG_CACHE: Dict[bytes, np.ndarray] = {}
_PK_CACHE: Dict[bytes, object] = {}
# pubkeys get the big cache: a mainnet validator set is ~1M keys and they
# repeat every slot; messages/signatures churn per epoch
_CACHE_CAPS = {id(_SIG_CACHE): 1 << 16, id(_MSG_CACHE): 1 << 16,
               id(_PK_CACHE): 1 << 20}


def _cache_put(cache: Dict, key: bytes, value) -> None:
    """Insert; at capacity, drop the least-recently-used half (hits
    refresh insertion order, so dict order is recency order)."""
    if len(cache) >= _CACHE_CAPS[id(cache)]:
        for k in list(cache.keys())[: len(cache) // 2]:
            cache.pop(k, None)
    cache[key] = value


def _cached(cache: Dict, key: bytes, compute):
    """Compute fns RETURN a ValueError value on validation failure; only
    successes are cached, so invalid inputs can neither occupy slots nor
    force evictions. A failure is raised here."""
    v = cache.get(key)
    if v is None:
        v = compute(key)
        if not isinstance(v, ValueError):
            _cache_put(cache, key, v)
    else:
        cache.pop(key, None)  # refresh recency
        cache[key] = v
    if isinstance(v, ValueError):
        raise v
    return v


def _pubkey_limbs_compute(pk: bytes):
    """KeyValidate + Montgomery-encode; failures are ValueError values."""
    aff = O.g1_from_bytes(pk)
    if aff is None:
        return ValueError("pubkey is the point at infinity")
    if not O.is_in_g1_subgroup(O.ec_from_affine(aff)):
        return ValueError("pubkey not in G1 subgroup")
    return fq.to_mont_int(aff[0].n), fq.to_mont_int(aff[1].n)


def _pubkey_limbs(pk: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Cached: validator pubkeys repeat across every slot of an epoch."""
    return _cached(_PK_CACHE, pk, _pubkey_limbs_compute)


def _signature_limbs_compute(sig: bytes):
    """(4, L) stacked Montgomery limbs, or the ValueError to re-raise."""
    aff = O.g2_from_bytes(sig)
    if aff is None:
        return ValueError("signature is the point at infinity")
    if not O.is_in_g2_subgroup(O.ec_from_affine(aff)):
        return ValueError("signature not in G2 subgroup")
    x, y = aff
    return np.stack(
        [
            fq.to_mont_int(x.c0),
            fq.to_mont_int(x.c1),
            fq.to_mont_int(y.c0),
            fq.to_mont_int(y.c1),
        ]
    )


def _signature_limbs(sig: bytes) -> np.ndarray:
    return _cached(_SIG_CACHE, sig, _signature_limbs_compute)


def _message_limbs_compute(message: bytes) -> np.ndarray:
    x, y = O.ec_to_affine(O.hash_to_g2(message, DST))
    return np.stack(
        [
            fq.to_mont_int(x.c0),
            fq.to_mont_int(x.c1),
            fq.to_mont_int(y.c0),
            fq.to_mont_int(y.c1),
        ]
    )


def _message_limbs(message: bytes) -> np.ndarray:
    """(4, L) stacked hash-to-G2 point limbs (dict-cached)."""
    return _cached(_MSG_CACHE, message, _message_limbs_compute)


# prep-plane counters: batched codec passes and the items they prepared,
# and the cache misses left to per-item prep because the codec is off
PREP_STATS = {
    "codec_batches": 0,
    "codec_items": 0,
    "serial_fallback_items": 0,
}


def reset_prep_state() -> None:
    with _STATS_LOCK:
        for k in PREP_STATS:
            PREP_STATS[k] = 0
    profiling.set_gauge("bls.prep_serial_fallback_items", 0.0)


def _codec_enabled() -> bool:
    return os.environ.get("CONSENSUS_SPECS_TPU_BATCH_CODEC", "1") != "0"


def _prewarm_batched(msgs, sigs, pks, device) -> None:
    """Fill the caches through the batched input codec. Validation
    failures come back as ValueError VALUES and are not cached, as in
    ``_cached`` (the item loop re-derives and raises them)."""
    from . import codec

    if msgs:
        for m, v in zip(msgs, codec.message_limbs_batch(msgs, DST, device)):
            _cache_put(_MSG_CACHE, m, v)
    if sigs:
        for s, v in zip(sigs, codec.signature_limbs_batch(sigs, device)):
            if not isinstance(v, ValueError):
                _cache_put(_SIG_CACHE, s, v)
    if pks:
        for p, v in zip(pks, codec.pubkey_limbs_batch(pks, device)):
            if not isinstance(v, ValueError):
                _cache_put(_PK_CACHE, p, v)


def prewarm_host_caches(messages: Sequence[bytes], signatures: Sequence[bytes],
                        pubkeys: Sequence[bytes] = (), device=None) -> None:
    """Fill the hash-to-G2, signature-decode and pubkey caches for every
    miss in one pass of the batched input codec (ops/codec.py) on
    ``device``. With CONSENSUS_SPECS_TPU_BATCH_CODEC=0 nothing is
    prepared here: the misses are counted and the item loop prepares them
    one by one. A codec error raises."""
    dev = resolve_device(device)
    msgs = [m for m in dict.fromkeys(messages) if m not in _MSG_CACHE]
    sigs = [s for s in dict.fromkeys(signatures) if s not in _SIG_CACHE]
    pks = [p for p in dict.fromkeys(pubkeys) if p not in _PK_CACHE]
    total = len(msgs) + len(sigs) + len(pks)
    if total == 0:
        return
    if not _codec_enabled():
        _bump(PREP_STATS, serial_fallback_items=total)
        profiling.set_gauge("bls.prep_serial_fallback_items",
                            PREP_STATS["serial_fallback_items"])
        return
    _prewarm_batched(msgs, sigs, pks, dev)
    _bump(PREP_STATS, codec_batches=1, codec_items=total)


# ---------------------------------------------------------------------------
# final exponentiation: host easy part, device hard part
# ---------------------------------------------------------------------------


def _flat_ints_to_oracle(coeffs: Sequence[int]) -> O.Fq12:
    sixes = []
    for half in range(2):
        fq2s = []
        for vi in range(3):
            k = 2 * vi + half
            b = coeffs[k + 6]
            a = (coeffs[k] + b) % P
            fq2s.append(O.Fq2(a, b))
        sixes.append(O.Fq6(*fq2s))
    return O.Fq12(sixes[0], sixes[1])


def _oracle_to_flat_ints(x: O.Fq12) -> List[int]:
    coeffs = [0] * 12
    for half, f6 in enumerate((x.c0, x.c1)):
        for vi, f2 in enumerate((f6.c0, f6.c1, f6.c2)):
            k = 2 * vi + half
            coeffs[k] = (coeffs[k] + f2.c0 - f2.c1) % P
            coeffs[k + 6] = (coeffs[k + 6] + f2.c1) % P
    return coeffs


def _easy_part_flat(f_coeffs: List[int]) -> Optional[List[int]]:
    """Host easy part: f -> f^((p^6-1)(p^2+1)); None if f is degenerate."""
    f = _flat_ints_to_oracle(f_coeffs)
    if f.is_zero():
        return None
    g = f.conjugate() * f.inverse()
    g = g.frobenius().frobenius() * g
    return _oracle_to_flat_ints(g)


def _ns(fold: int, t: int) -> str:
    return f"i{t}." if fold > 1 else ""


class _FoldLayout:
    """Row/lane layout of a folded batch — the one place that knows item i
    lives at row i // fold under name prefix _ns(fold, i % fold), so the
    scatter and the readback can never diverge."""

    __slots__ = ("program", "fold", "rows", "nb")

    def __init__(self, kind: str, k: int, n_items: int, fold=None):
        if fold is None:
            fold = _fold_for(kind, k, n_items)
        self.program, self.fold = _program(kind, k, fold=fold)
        self.rows = _pow2(max(1, -(-n_items // self.fold)))
        self.nb = self.rows * self.fold

    def views(self, arr: np.ndarray) -> np.ndarray:
        """(nb, ...) staging array -> (rows, fold, ...) view."""
        return arr.reshape((self.rows, self.fold) + arr.shape[1:])

    def split(self, i: int) -> Tuple[int, str]:
        """Item index -> (row, name prefix)."""
        r, t = divmod(i, self.fold)
        return r, _ns(self.fold, t)

    def scatter(self, ins: Dict[str, np.ndarray], arr: np.ndarray, name_fn):
        """Register a (nb, *inner, L) staging array's slices under their
        folded input names: ins[prefix + name_fn(*inner_idx)]."""
        v = self.views(arr)
        inner = v.shape[2:-1]
        for t in range(self.fold):
            ns = _ns(self.fold, t)
            for idx in np.ndindex(*inner):
                ins[ns + name_fn(*idx)] = v[(slice(None), t) + idx]


def _easy_part_batch(out, lay, precheck, aggz: bool):
    """Readback of PROG A outputs + the easy part for every active item,
    serially. Returns (g_batch, agg_nonzero | None); degenerate items
    clear their precheck bit in place."""
    nb = len(precheck)
    agg_nonzero = np.zeros(nb, dtype=bool) if aggz else None
    g_batch = np.zeros((nb, 12, fq.NUM_LIMBS), dtype=np.uint64)
    for i in range(nb):
        if not precheck[i]:
            continue
        r, ns = lay.split(i)
        if aggz:
            agg_nonzero[i] = fq.from_mont_limbs(out[f"{ns}aggz"][r]) != 0
        g = _easy_part_flat(
            [fq.from_mont_limbs(out[f"{ns}f.{j}"][r]) for j in range(12)])
        if g is None:
            precheck[i] = False
        else:
            g_batch[i] = np.stack([fq.to_mont_int(c) for c in g])
    return g_batch, agg_nonzero


def _finalize_per_item(fs: np.ndarray, device) -> np.ndarray:
    """(N, 12, L) loose Miller-output rows -> (N,) bool through the
    per-item finalization the two batch entry points use (N serial host
    easy parts, N hard-part rows on ``device``), callable on raw f rows so
    the RLC bench races it against the combine on the same inputs."""
    dev = resolve_device(device)
    n = fs.shape[0]
    g_batch = np.zeros((n, 12, fq.NUM_LIMBS), dtype=np.uint64)
    active = np.zeros(n, dtype=bool)
    for i in range(n):
        g = _easy_part_flat([fq.from_mont_limbs(fs[i, j]) for j in range(12)])
        if g is not None:
            g_batch[i] = np.stack([fq.to_mont_int(c) for c in g])
            active[i] = True
    ok = _run_hard_part(g_batch, dev)
    return ok & active


# hard-part program variants: all three share the g.*/res.* I/O contract,
# so routing is purely a program-kind choice
_HARD_PART_KINDS = {
    "bit_serial": "hard_part",
    "windowed": "hard_part_windowed",
    "frobenius": "hard_part_frobenius",
}


def _hard_part_kind(n_items: int) -> str:
    """Which hard-part program serves an n_items batch.
    CONSENSUS_SPECS_TPU_HARD_PART pins a variant (bit_serial | windowed |
    frobenius); 'auto' (default) takes the Frobenius width-for-depth
    variant (shorter critical path) up to 16 rows and the bit-serial chain
    (fewer multiplies) once the lanes saturate."""
    v = os.environ.get("CONSENSUS_SPECS_TPU_HARD_PART", "auto")
    if v in _HARD_PART_KINDS:
        return _HARD_PART_KINDS[v]
    return "hard_part_frobenius" if n_items <= 16 else "hard_part"


def _run_hard_part(g_flat_batch: np.ndarray, device,
                   kind: str = None) -> np.ndarray:
    """(N, 12, L) unitary g limb batch -> (N,) bool (res == 1). Counts N
    rows against RLC_STATS['final_exps']. ``kind`` overrides the variant
    route (_hard_part_kind)."""
    n = g_flat_batch.shape[0]
    _bump(RLC_STATS, final_exps=n)
    if kind is None:
        kind = _hard_part_kind(n)
    lay = _FoldLayout(kind, 0, n)
    gb = np.zeros((lay.nb, 12, fq.NUM_LIMBS), dtype=np.uint64)
    gb[:n] = g_flat_batch
    ins = {}
    lay.scatter(ins, gb, lambda i: f"g.{i}")
    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=device)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        r, ns = lay.split(i)
        res = [fq.from_mont_limbs(out[f"{ns}res.{j}"][r]) for j in range(12)]
        ok[i] = res[0] == 1 and all(rc == 0 for rc in res[1:])
    return ok


class _FinalExpBatcher:
    """Coalesces CONCURRENT device-routed hard-part rows into one VM
    execution: when several RLC checks are in flight at once, their single
    rows run as one multi-row program.

    Protocol: the first arriving thread becomes the window leader, sleeps
    CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS (default 2 ms), then executes
    every row that joined (on its own current stream) and resolves the
    followers with plain bools. Rows cross threads as numpy arrays, never
    as CUDA tensors. Windows are keyed by the resolved ``torch.device``,
    so rows bound for different devices never share an execution."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = {}  # device -> [[g_row, result | Exception, Event]]
        self._leaders = set()  # devices with an active window leader

    def run(self, g_row: np.ndarray, device) -> bool:
        window = float(os.environ.get(
            "CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS", "2")) / 1e3
        entry = [g_row, None, threading.Event()]
        with self._lock:
            self._pending.setdefault(device, []).append(entry)
            lead = device not in self._leaders
            if lead:
                self._leaders.add(device)
        if not lead:
            entry[2].wait()
            if isinstance(entry[1], BaseException):
                raise entry[1]
            return entry[1]
        # the leader owes every follower a resolution no matter what: an
        # interrupt mid-sleep or mid-execute must fail the joined entries
        # (and release the leader slot), never leave them blocked
        batch = None
        try:
            if window > 0:
                time.sleep(window)
            with self._lock:
                batch = self._pending.pop(device, [])
                self._leaders.discard(device)  # later arrivals re-elect
                n = len(batch)
            _bump(RLC_STATS, final_exp_windows=1, final_exp_window_rows=n)
            rows = np.stack([e[0] for e in batch])
            kind = _hard_part_kind(n)
            profiling.set_gauge("bls.final_exp_rows_inflight", n)
            flight.note("vm", "final_exp_route", route="device", rows=n,
                        variant=kind)
            ok = _run_hard_part(rows, device, kind=kind)
        except BaseException as e:
            if batch is None:  # died before collecting: take over now
                with self._lock:
                    batch = self._pending.pop(device, [])
                    self._leaders.discard(device)
            # followers re-raise the original Exception; a BaseException
            # (KeyboardInterrupt/SystemExit) stays with the leader and the
            # followers get a RuntimeError instead
            err = e if isinstance(e, Exception) else RuntimeError(
                f"final-exp window leader died: {e!r}")
            for other in batch:
                if other is not entry:
                    other[1] = err
                    other[2].set()
            raise
        mine = None
        for other, r in zip(batch, ok):
            if other is entry:
                mine = bool(r)
            else:
                other[1] = bool(r)
                other[2].set()
        return mine


_FINAL_EXP_BATCHER = _FinalExpBatcher()


# ---------------------------------------------------------------------------
# batched public API
# ---------------------------------------------------------------------------

# entry-point counters: batch calls and the items they carried (the serve
# plane's dedup checks read them: every distinct check verified once)
CALL_COUNTS = {
    "batch_fast_aggregate_verify": 0,
    "batch_aggregate_verify": 0,
    "batch_verify_rlc": 0,
    "items": 0,
}


def _count_call(name: str, n_items: int) -> None:
    with _STATS_LOCK:
        CALL_COUNTS[name] += 1
        CALL_COUNTS["items"] += n_items


def reset_call_counts() -> None:
    with _STATS_LOCK:
        for k in CALL_COUNTS:
            CALL_COUNTS[k] = 0


# RLC-plane counters: combine programs run, failed combined checks that
# forced a bisection split, hard-part evaluations paid (device rows,
# padding included, + host-oracle hard parts), candidates that reached
# the combine, and the final-exp batcher's windows and the rows they
# coalesced
RLC_STATS = {
    "combines": 0,
    "bisections": 0,
    "final_exps": 0,
    "items": 0,
    "final_exp_windows": 0,
    "final_exp_window_rows": 0,
}


def _export_rlc_gauges() -> None:
    profiling.set_gauge("bls.rlc_combines", RLC_STATS["combines"])
    profiling.set_gauge("bls.rlc_bisections", RLC_STATS["bisections"])
    profiling.set_gauge("bls.final_exps", RLC_STATS["final_exps"])


def reset_rlc_stats() -> None:
    with _STATS_LOCK:
        for k in RLC_STATS:
            RLC_STATS[k] = 0
    _export_rlc_gauges()


def _miller_fast_aggregate(
    pubkey_sets, messages, signatures, device
) -> Tuple[Optional[dict], "_FoldLayout", np.ndarray]:
    """PROG A stage of batch_fast_aggregate_verify: prep (the codec
    prewarm, then the cached limbs per item) + the aggregate-and-Miller
    program. Returns (out, lay, precheck); ``out`` is
    None when no item survived host prep."""
    n = len(pubkey_sets)
    max_k = max((len(pks) for pks in pubkey_sets), default=1)
    k = _k_bucket(max(1, max_k))
    L = fq.NUM_LIMBS

    lay = _FoldLayout("miller_product", k, n)
    nb = lay.nb
    prewarm_host_caches(
        [bytes(m) for m in messages],
        [bytes(s) for s in signatures],
        [bytes(pk) for pks in pubkey_sets for pk in pks],
        device,
    )
    # stacked staging arrays; inactive-lane fillers: infinity pubkeys
    # (0:1:0), generator G2 points
    precheck = np.zeros(nb, dtype=bool)
    pk_x = np.zeros((nb, k, L), dtype=np.uint64)
    pk_y = np.zeros((nb, k, L), dtype=np.uint64)
    pk_y[:] = _INF_G1[1]
    pk_z = np.zeros((nb, k, L), dtype=np.uint64)
    hm = np.zeros((nb, 4, L), dtype=np.uint64)
    hm[:] = _G2GEN_LIMBS
    sg = np.zeros((nb, 4, L), dtype=np.uint64)
    sg[:] = _G2GEN_LIMBS

    for i, (pks, msg, sig) in enumerate(zip(pubkey_sets, messages, signatures)):
        try:
            if len(pks) == 0:
                raise ValueError("empty pubkey set")
            enc = [_pubkey_limbs(bytes(pk)) for pk in pks]
            s = _signature_limbs(bytes(sig))
            h = _message_limbs(bytes(msg))
        except (ValueError, TypeError):
            continue  # host prep failed: the item is False
        m = len(enc)
        pk_x[i, :m] = [e[0] for e in enc]
        pk_y[i, :m] = [e[1] for e in enc]
        pk_z[i, :m] = _ONE_LIMBS
        hm[i] = h
        sg[i] = s
        precheck[i] = True

    if not precheck.any():
        return None, lay, precheck

    ins = {}
    lay.scatter(ins, pk_x, lambda j: f"pk{j}.x")
    lay.scatter(ins, pk_y, lambda j: f"pk{j}.y")
    lay.scatter(ins, pk_z, lambda j: f"pk{j}.z")
    lay.scatter(ins, hm, lambda ci: f"h.{_G2_COMPS[ci]}")
    lay.scatter(ins, sg, lambda ci: f"sig.{_G2_COMPS[ci]}")

    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=device)
    return out, lay, precheck


def batch_fast_aggregate_verify(
    pubkey_sets: Sequence[Sequence[bytes]],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    device=None,
) -> np.ndarray:
    """N independent FastAggregateVerify calls in one device pipeline
    (reference specs/phase0/beacon-chain.md's per-attestation verify)."""
    dev = resolve_device(device)
    n = len(pubkey_sets)
    if len(messages) != n or len(signatures) != n:
        raise ValueError("pubkey_sets, messages and signatures differ in length")
    _count_call("batch_fast_aggregate_verify", n)
    if n == 0:
        return np.zeros(0, dtype=bool)
    out, lay, precheck = _miller_fast_aggregate(
        pubkey_sets, messages, signatures, dev
    )
    if out is None:
        return precheck[:n]
    g_batch, agg_nonzero = _easy_part_batch(out, lay, precheck, aggz=True)
    ok = _run_hard_part(g_batch, dev)
    return (ok & precheck & agg_nonzero)[:n]


def _miller_aggregate(
    pubkey_lists, message_lists, signatures, device
) -> Tuple[Optional[dict], "_FoldLayout", np.ndarray]:
    """PROG A stage of batch_aggregate_verify (distinct message per
    pubkey); same contract as _miller_fast_aggregate."""
    n = len(pubkey_lists)
    max_k = max((len(pks) for pks in pubkey_lists), default=1)
    k = _k_bucket(max(1, max_k))
    L = fq.NUM_LIMBS

    lay = _FoldLayout("aggregate_verify", k, n)
    nb = lay.nb
    prewarm_host_caches(
        [bytes(m) for ms in message_lists for m in ms],
        [bytes(s) for s in signatures],
        [bytes(pk) for pks in pubkey_lists for pk in pks],
        device,
    )
    precheck = np.zeros(nb, dtype=bool)
    pk_x = np.zeros((nb, k, L), dtype=np.uint64)
    pk_y = np.zeros((nb, k, L), dtype=np.uint64)
    pk_y[:] = _INF_G1[1]
    pk_z = np.zeros((nb, k, L), dtype=np.uint64)
    hm = np.zeros((nb, k, 4, L), dtype=np.uint64)
    hm[:] = _G2GEN_LIMBS
    sg = np.zeros((nb, 4, L), dtype=np.uint64)
    sg[:] = _G2GEN_LIMBS

    for i, (pks, msgs, sig) in enumerate(
        zip(pubkey_lists, message_lists, signatures)
    ):
        try:
            if len(pks) == 0 or len(pks) != len(msgs):
                raise ValueError("bad pubkey/message lists")
            enc = [_pubkey_limbs(bytes(pk)) for pk in pks]
            hs = [_message_limbs(bytes(m)) for m in msgs]
            s = _signature_limbs(bytes(sig))
        except (ValueError, TypeError):
            continue  # host prep failed: the item is False
        m = len(enc)
        pk_x[i, :m] = [e[0] for e in enc]
        pk_y[i, :m] = [e[1] for e in enc]
        pk_z[i, :m] = _ONE_LIMBS
        hm[i, :m] = hs
        sg[i] = s
        precheck[i] = True

    if not precheck.any():
        return None, lay, precheck

    ins = {}
    lay.scatter(ins, pk_x, lambda j: f"pk{j}.x")
    lay.scatter(ins, pk_y, lambda j: f"pk{j}.y")
    lay.scatter(ins, pk_z, lambda j: f"pk{j}.z")
    lay.scatter(ins, hm, lambda j, ci: f"h{j}.{_G2_COMPS[ci]}")
    lay.scatter(ins, sg, lambda ci: f"sig.{_G2_COMPS[ci]}")

    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=device)
    return out, lay, precheck


def batch_aggregate_verify(
    pubkey_lists: Sequence[Sequence[bytes]],
    message_lists: Sequence[Sequence[bytes]],
    signatures: Sequence[bytes],
    device=None,
) -> np.ndarray:
    """N independent AggregateVerify calls (distinct messages per pubkey).
    Inactive pair lanes use infinity G1 (their Miller factor lands in a
    proper subfield, killed by the final exponentiation)."""
    dev = resolve_device(device)
    n = len(pubkey_lists)
    if len(message_lists) != n or len(signatures) != n:
        raise ValueError("pubkey_lists, message_lists and signatures differ "
                         "in length")
    _count_call("batch_aggregate_verify", n)
    if n == 0:
        return np.zeros(0, dtype=bool)
    out, lay, precheck = _miller_aggregate(
        pubkey_lists, message_lists, signatures, dev
    )
    if out is None:
        return precheck[:n]
    g_batch, _ = _easy_part_batch(out, lay, precheck, aggz=False)
    ok = _run_hard_part(g_batch, dev)
    return (ok & precheck)[:n]


# ---------------------------------------------------------------------------
# RLC batch verification: one final exponentiation per micro-batch
# ---------------------------------------------------------------------------


def rlc_enabled() -> bool:
    """Serve-plane default: micro-batches ride the RLC path unless
    CONSENSUS_SPECS_TPU_RLC=0 reverts to per-item final exponentiation."""
    return os.environ.get("CONSENSUS_SPECS_TPU_RLC", "1") != "0"


def _rlc_backend() -> str:
    """Combine-stage backend (CONSENSUS_SPECS_TPU_RLC_BACKEND): 'vm' (the
    rlc_combine program on the step kernel, default) or 'jax' (the tower
    combine, ops/pairing.rlc_combine, on the Montgomery kernel; the name
    is the JAX package's)."""
    v = os.environ.get("CONSENSUS_SPECS_TPU_RLC_BACKEND", "vm")
    return v if v == "jax" else "vm"


def _rlc_chunk_max() -> int:
    """f's combined per VM program instance (CONSENSUS_SPECS_TPU_RLC_CHUNK,
    default 16: saturates the mul lanes). Bigger batches run more chunk
    rows and host-multiply the chunk products."""
    return max(1, int(os.environ.get("CONSENSUS_SPECS_TPU_RLC_CHUNK", "16")))


def _rlc_final_mode(device) -> str:
    """Where the ONE combined hard part runs (CONSENSUS_SPECS_TPU_RLC_FINAL):
    'device' (a hard-part VM row through _FinalExpBatcher) or 'host' (the
    exact-int oracle). 'auto' (default) picks host when the call's device
    is the CPU, where the plain steps lose to the ~20 ms oracle, and
    device on the card. Both are exact."""
    v = os.environ.get("CONSENSUS_SPECS_TPU_RLC_FINAL", "auto")
    if v in ("host", "device"):
        return v
    return "host" if torch.device(device).type == "cpu" else "device"


def _rlc_scalars(m: int, rng=None) -> np.ndarray:
    """(m, RLC_BITS) uint8 msb-first bit matrix of m fresh NONZERO random
    scalars: from ``rng.getrandbits`` when injected (deterministic tests),
    else os.urandom."""
    nbits = vmlib.RLC_BITS
    bits = np.zeros((m, nbits), dtype=np.uint8)
    for i in range(m):
        r = 0
        while r == 0:
            if rng is not None:
                r = rng.getrandbits(nbits)
            else:
                r = int.from_bytes(os.urandom(nbits // 8), "big")
        for t in range(nbits):
            bits[i, t] = (r >> (nbits - 1 - t)) & 1
    return bits


def _oracle_unitary_pow_abs(g, bits):
    acc = g
    for b in bits[1:]:
        acc = acc * acc
        if b:
            acc = acc * g
    return acc


def hard_part_res_oracle(g) -> "O.Fq12":
    """Exact-int hard part RESULT on a unitary oracle Fq12: the host twin
    of PROG B, the decomposition of vmlib.build_hard_part (inverse ==
    conjugate in the cyclotomic subgroup)."""
    px = lambda t: _oracle_unitary_pow_abs(t, vmlib.ABS_X_BITS).conjugate()
    px1 = lambda t: _oracle_unitary_pow_abs(
        t, vmlib.ABS_X_PLUS_1_BITS).conjugate()
    t0 = px1(px1(g))
    t1 = px(t0) * t0.frobenius()
    t2 = px(px(t1))
    t2 = t2 * t1.frobenius().frobenius()
    t2 = t2 * t1.conjugate()
    return t2 * (g * g * g)


def _hard_part_is_one_oracle(g_coeffs: List[int]) -> bool:
    """res == 1 verdict over hard_part_res_oracle."""
    _bump(RLC_STATS, final_exps=1)
    g = _flat_ints_to_oracle(g_coeffs)
    return _oracle_to_flat_ints(hard_part_res_oracle(g)) == [1] + [0] * 11


def _final_exp_is_one(f_coeffs: List[int], device) -> bool:
    """ONE full final exponentiation on exact coefficients: the host easy
    part, then the hard part per _rlc_final_mode(device). Device routes go
    through the final-exp batcher."""
    g = _easy_part_flat(f_coeffs)
    if g is None:
        return False  # degenerate f: no valid item produces it
    if _rlc_final_mode(device) == "host":
        flight.note("vm", "final_exp_route", route="host", rows=1)
        return _hard_part_is_one_oracle(g)
    gm = np.stack([fq.to_mont_int(c) for c in g])
    return bool(_FINAL_EXP_BATCHER.run(gm, device))


def _rlc_chunk(m: int) -> int:
    """f's per rlc_combine program instance for an m-candidate combine."""
    return min(_pow2(m), _rlc_chunk_max())


def _rlc_combine_inputs(fs: np.ndarray, bits: np.ndarray):
    """The rlc_combine layout and named inputs for an (m, 12, L) f batch
    and its (m, RLC_BITS) bits: (lay, ins, n_chunks). Inactive lanes get
    f = 1 and all-zero bits (1^0 = 1)."""
    m = fs.shape[0]
    chunk = _rlc_chunk(m)
    n_chunks = -(-m // chunk)
    lay = _FoldLayout("rlc_combine", chunk, n_chunks)
    L = fq.NUM_LIMBS
    fb = np.zeros((lay.nb, chunk, 12, L), dtype=np.uint64)
    fb[:, :, 0] = _ONE_LIMBS
    rb = np.zeros((lay.nb, chunk, vmlib.RLC_BITS, L), dtype=np.uint64)
    fb.reshape(lay.nb * chunk, 12, L)[:m] = fs
    rb.reshape(lay.nb * chunk, vmlib.RLC_BITS, L)[:m] = np.where(
        bits[..., None].astype(bool), _ONE_LIMBS, np.uint64(0))
    ins = {}
    lay.scatter(ins, fb, lambda i, j: f"f{i}.{j}")
    lay.scatter(ins, rb, lambda i, t: f"r{i}.{t}")
    return lay, ins, n_chunks


def _rlc_combine_vm(fs: np.ndarray, bits: np.ndarray, device) -> List[int]:
    """Combine through the rlc_combine program (one vm.execute: kernel 1
    on the card), then one host oracle Fq12 product per extra chunk.
    Returns the exact flat coefficients of prod f_i^{r_i}."""
    lay, ins, n_chunks = _rlc_combine_inputs(fs, bits)
    out = vm.execute(lay.program, ins, batch_shape=(lay.rows,), device=device)
    total = None
    for c in range(n_chunks):
        r, ns = lay.split(c)
        x = _flat_ints_to_oracle(
            [fq.from_mont_limbs(out[f"{ns}c.{j}"][r]) for j in range(12)])
        total = x if total is None else total * x
    return _oracle_to_flat_ints(total)


def _rlc_combine_tower(fs: np.ndarray, bits: np.ndarray, device) -> List[int]:
    """Combine through the tower arithmetic (ops/pairing.rlc_combine) on
    ``device``: every Fq12 product is a kernel 2 launch on the card. The
    counterpart of the JAX package's _rlc_combine_jax."""
    from . import pairing

    c = pairing.rlc_combine(
        fq.limbs_from_numpy(fs, device),
        torch.from_numpy(bits.astype(bool)).to(device))
    c = c.cpu().numpy().astype(np.uint64)
    return [fq.from_mont_limbs(c[j]) for j in range(12)]


def batch_verify_rlc(items, device=None, rng=None) -> np.ndarray:
    """N independent verifications decided by random linear combination:
    check prod_i f_i^{r_i} == 1 (after the final exponentiation) for fresh
    random nonzero 128-bit scalars r_i, so the batch pays ONE easy part
    and ONE hard part instead of N of each.

    ``items``: sequence of (kind, pubkeys, messages, signature) with kind
    'fast_aggregate' (one message) or 'aggregate' (per-key messages).
    Items are grouped by (kind, K bucket) for PROG A, and the Miller
    outputs feed the combine as raw loose limbs.

    Soundness (Schwartz-Zippel): a batch holding any invalid item passes
    with probability <= 2^-128 over the fresh per-combine scalars (from
    os.urandom; ``rng``, anything with getrandbits, overrides them for
    deterministic tests). An all-valid batch always passes. A failed
    combined check bisects: each half is re-combined with fresh scalars,
    down to exact per-item finalization of singletons. One candidate
    takes the plain per-item finalization with no combine."""
    dev = resolve_device(device)
    items = list(items)
    n = len(items)
    _count_call("batch_verify_rlc", n)
    if n == 0:
        return np.zeros(0, dtype=bool)
    verdict = np.zeros(n, dtype=bool)

    groups: Dict[Tuple[str, int], List[int]] = {}
    for i, (kind, pks, _msgs, _sig) in enumerate(items):
        if kind not in ("fast_aggregate", "aggregate"):
            raise ValueError(f"unknown check kind {kind!r}")
        groups.setdefault((kind, _k_bucket(max(1, len(pks)))), []).append(i)

    # PROG A per (kind, bucket) group; the surviving candidates' Miller
    # outputs as raw limb rows (host precheck and infinite-aggregate
    # failures are False without any finalization work)
    cand_idx: List[int] = []
    fs_rows: List[np.ndarray] = []
    for (kind, _bucket), idxs in groups.items():
        sub = [items[i] for i in idxs]
        miller = (_miller_fast_aggregate if kind == "fast_aggregate"
                  else _miller_aggregate)
        out, lay, precheck = miller([it[1] for it in sub],
                                    [it[2] for it in sub],
                                    [it[3] for it in sub], dev)
        if out is None:
            continue
        for pos, i in enumerate(idxs):
            if not precheck[pos]:
                continue
            r, ns = lay.split(pos)
            if kind == "fast_aggregate" and (
                    fq.from_mont_limbs(out[f"{ns}aggz"][r]) == 0):
                continue  # aggregate pubkey is infinity: False, no crypto
            fs_rows.append(np.stack([out[f"{ns}f.{j}"][r] for j in range(12)]))
            cand_idx.append(i)

    m = len(cand_idx)
    _bump(RLC_STATS, items=m)
    if m == 0:
        _export_rlc_gauges()
        return verdict
    fs = np.stack(fs_rows)  # (m, 12, L), loose limbs straight from PROG A

    def finalize_item(j: int) -> bool:
        coeffs = [fq.from_mont_limbs(fs[j, c]) for c in range(12)]
        return _final_exp_is_one(coeffs, dev)

    def combine_check(sel: List[int]) -> bool:
        _bump(RLC_STATS, combines=1)
        bits = _rlc_scalars(len(sel), rng)
        sub = fs[np.asarray(sel)]
        if _rlc_backend() == "jax":
            coeffs = _rlc_combine_tower(sub, bits, dev)
        else:
            coeffs = _rlc_combine_vm(sub, bits, dev)
        return _final_exp_is_one(coeffs, dev)

    def resolve(sel: List[int]) -> None:
        if len(sel) == 1:
            verdict[cand_idx[sel[0]]] = finalize_item(sel[0])
            return
        if combine_check(sel):
            for j in sel:
                verdict[cand_idx[j]] = True
            return
        _bump(RLC_STATS, bisections=1)
        mid = len(sel) // 2
        resolve(sel[:mid])
        resolve(sel[mid:])

    if m == 1:
        verdict[cand_idx[0]] = finalize_item(0)  # plain-path degeneration
    else:
        resolve(list(range(m)))
    _export_rlc_gauges()
    return verdict


# ---------------------------------------------------------------------------
# single-call API (reference utils/bls.py semantics)
# ---------------------------------------------------------------------------


def verify(PK: bytes, message: bytes, signature: bytes, device=None) -> bool:
    return bool(batch_fast_aggregate_verify(
        [[PK]], [message], [signature], device=device)[0])


def fast_aggregate_verify(
    pubkeys: Sequence[bytes], message: bytes, signature: bytes, device=None
) -> bool:
    resolve_device(device)
    if len(pubkeys) == 0:
        return False
    return bool(batch_fast_aggregate_verify(
        [list(pubkeys)], [message], [signature], device=device)[0])


def aggregate_verify(
    pubkeys: Sequence[bytes], messages: Sequence[bytes], signature: bytes,
    device=None,
) -> bool:
    resolve_device(device)
    if len(pubkeys) == 0 or len(pubkeys) != len(messages):
        return False
    return bool(batch_aggregate_verify(
        [list(pubkeys)], [list(messages)], [signature], device=device)[0])
