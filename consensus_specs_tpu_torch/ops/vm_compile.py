"""Fused straight-line lowering of field-ALU VM programs: the port's
counterpart of consensus_specs_tpu/ops/vm_compile.py.

The interpreter (ops/vm.py) runs every step of an assembled program over
all lanes of both units, idle ones included, through a register file. This
module runs the SAME schedule as straight-line code instead: one SSA value
per real op, and per scheduled level one batched Montgomery product over
exactly that level's live operands (``fq.mont_mul``: on the card a launch
of the Montgomery kernel, csrc/mont_mul.cu; on the CPU its plain version)
and one carry pass over the level's add and borrowless-subtract lanes.

STRUCTURAL DEDUP, as in the JAX package (``vm_analysis.plan_structures``):
the schedule is cut into level chunks aligned to the ladder period, each
chunk canonicalized up to constant values and live-set permutation into a
STRUCTURE, and a chunk becomes an INSTANCE of its structure with runtime
tables (``in_idx`` gathers its inputs from the inter-chunk carry,
``consts`` holds its constants, ``boundary_idx`` assembles the next carry
from [body outputs ++ carry]). Runs of same-structure instances with a
shape-invariant carry fold into scan blocks (``vm_analysis.scan_blocks``).

On the card a unit, one structure's step or scan block at one row count,
is ONE CUDA graph per (unit, rows, replay stream), captured once on the
capturing thread's own stream in thread-local mode (``cuda_fq.capture``)
and replayed with each instance's tables copied into the graph's static
buffers; a scan block is one graph of its instances in sequence. The
kernel launches a graph holds are counted at every replay, so
``cuda_fq.LAUNCHES`` stays exact. The plans and structure bodies are
disk-cached beside the interpreter programs (``fusedplan_l<ver>_...`` and
shared ``fusedstruct_l<ver>_<hash>.pkl`` under ``.vm_cache_torch/``); the
graphs are built anew in each process (CUDA graphs do not persist).

Outputs are limb-identical to the interpreter's: the per-op integer maps
(Montgomery reduction, carried add, borrowless subtract) are the same, and
the tests and the vmexec smoke hold both routes to the exact-int IR oracle
(``vm_analysis.eval_ir``).

Routing (``CONSENSUS_SPECS_TPU_VM_EXEC``): ``interp`` pins the
interpreter, ``fused`` this lowering, ``auto`` (default) takes fused only
when the measured warm ms/row pair (in-process, seeded from the plan's
persisted measurements) says fused wins AND the units are already built
in-process for the call's (rows, stream). With
``CONSENSUS_SPECS_TPU_VM_WARM_BG=1`` a missing signature is built by a
background thread instead, and ``auto`` flips once it is ready. A failure
in the fused route falls back to the interpreter with a
``vm/fused_fallback`` flight event.
"""
import math
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils import torch_env
from . import fq, vm_analysis

# bump when the lowering's code or plan format changes: re-keys every fused
# cache entry independently of the interpreter programs
LOWERING_VERSION = 1

# bump when the PLANNING heuristics change without changing the code: a
# cached plan of an older policy is still correct but not what the
# planner would produce now, so it re-derives
PLAN_POLICY = 1


def exec_mode() -> str:
    """CONSENSUS_SPECS_TPU_VM_EXEC, normalized (interp | fused | auto)."""
    v = os.environ.get("CONSENSUS_SPECS_TPU_VM_EXEC", "auto")
    return v if v in ("interp", "fused", "auto") else "auto"


# a malformed or non-positive knob never raises mid-call: one stderr
# line, then the documented default
_ENV_WARNED = set()


def _env_warn_once(name: str, raw, default) -> None:
    if name not in _ENV_WARNED:
        _ENV_WARNED.add(name)
        print(
            f"vm_compile: ignoring invalid {name}={raw!r} — "
            f"using the default ({default})",
            file=sys.stderr,
        )


def _env_pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "" or raw == "0":
        return default  # unset/0 = "use the default", not an error
    try:
        v = int(raw)
    except ValueError:
        v = None
    if v is None or v <= 0:
        _env_warn_once(name, raw, default)
        return default
    return v


def chunk_steps() -> int:
    """Target scheduled levels per chunk (CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK,
    default vm_analysis.FUSED_CHUNK_STEPS; the dedup window aligns it to
    the detected ladder period, within 2x)."""
    return _env_pos_int("CONSENSUS_SPECS_TPU_VM_FUSED_CHUNK",
                        vm_analysis.FUSED_CHUNK_STEPS)


def dedup_enabled() -> bool:
    """CONSENSUS_SPECS_TPU_VM_DEDUP: structural chunk dedup (default on;
    ``0`` gives every chunk its own structure and no scan blocks)."""
    raw = os.environ.get("CONSENSUS_SPECS_TPU_VM_DEDUP")
    if raw is None or raw in ("1", ""):
        return True
    if raw == "0":
        return False
    _env_warn_once("CONSENSUS_SPECS_TPU_VM_DEDUP", raw, "1")
    return True


def _superop_env() -> Optional[int]:
    """CONSENSUS_SPECS_TPU_VM_SUPEROP: None = auto (the
    ``vm_analysis.auto_min_run`` rule), 0 = off, int >= 2 = a forced
    minimum run length."""
    raw = os.environ.get("CONSENSUS_SPECS_TPU_VM_SUPEROP", "auto")
    if raw in ("auto", ""):
        return None
    if raw in ("off", "0"):
        return 0
    try:
        v = int(raw)
        if v >= 2:
            return v
    except ValueError:
        pass
    _env_warn_once("CONSENSUS_SPECS_TPU_VM_SUPEROP", raw, "auto")
    return None


def superop_min_run(plan: Dict) -> int:
    """Minimum same-structure run length folded into one scan block (0 =
    never fold)."""
    v = _superop_env()
    if v is not None:
        return v
    return vm_analysis.auto_min_run(plan)


def _bg_warm_enabled() -> bool:
    """CONSENSUS_SPECS_TPU_VM_WARM_BG=1: an auto-routed execution whose
    signature is not built yet enqueues a background warm."""
    return os.environ.get("CONSENSUS_SPECS_TPU_VM_WARM_BG") == "1"


# plans built, fused executions, interpreter fallbacks, unit hits and
# misses (a miss builds a unit: a graph capture on the card) and graph
# captures; exported as vm.fused_* gauges
_COUNTERS = {"programs": 0, "executions": 0, "fallbacks": 0,
             "struct_hits": 0, "struct_misses": 0, "captures": 0}
_COUNT_LOCK = threading.Lock()
_BUILT_STRUCTS = set()  # distinct structure keys built in-process


def _bump(**deltas) -> None:
    with _COUNT_LOCK:
        for k, n in deltas.items():
            _COUNTERS[k] += n


def _export_gauges() -> None:
    from . import profiling

    profiling.set_gauge("vm.fused_programs", _COUNTERS["programs"])
    profiling.set_gauge("vm.fused_executions", _COUNTERS["executions"])
    profiling.set_gauge("vm.fused_fallbacks", _COUNTERS["fallbacks"])
    profiling.set_gauge("vm.fused_structs", len(_BUILT_STRUCTS))
    profiling.set_gauge("vm.fused_struct_hits", _COUNTERS["struct_hits"])
    profiling.set_gauge("vm.fused_struct_misses",
                        _COUNTERS["struct_misses"])
    profiling.set_gauge("vm.fused_captures", _COUNTERS["captures"])


def _flight_note(kind: str, **data) -> None:
    try:
        from ..obs import flight

        flight.note("vm", kind, **data)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# one canonical structure: its levels as index tensors into a value buffer
# ---------------------------------------------------------------------------

# MP + 1 + MASK, limb by limb: a borrowless-subtract lane's right operand
# is (MP + 1) + (MASK - b) = this - b (one op; every limb stays >= 0)
_MP1_MASK = (fq._int_to_limbs_np(fq.MP + 1).astype(np.int64) + fq.MASK)
_BIT = np.arange(fq.NUM_LIMBS, dtype=np.int64)


def _carry_fixed(t: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """Carried limbs of the value of ``t`` (slots, rows, 15) mod 2^420,
    in a fixed sequence of ops (no data-dependent loop, so a graph can
    capture it). Needs every limb of ``t`` below 2^40: one parallel carry
    pass leaves each limb at most MASK + 2^12, so a limb then either
    generates one carry (>= 2^28), propagates an incoming one (== MASK)
    or absorbs it; the carries into all 15 limbs follow at once from the
    binary sum of the generate and propagate bit masks, as in a
    carry-lookahead adder. Limb for limb ``fq._carry_limbs``."""
    dev = t.device
    y = t & fq.MASK
    y[..., 1:] += t[..., :-1] >> fq.LIMB_BITS
    bit = _const(dev, "bit")
    gen = ((y >> fq.LIMB_BITS) << bit).sum(-1)
    prop = ((y == fq.MASK).to(torch.int64) << bit).sum(-1)
    either = gen | prop
    carries = ((either + gen) ^ either ^ gen).unsqueeze(-1)
    y += (carries >> bit) & 1
    return torch.bitwise_and(y, fq.MASK, out=out)


_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(dev, name: str) -> torch.Tensor:
    key = (str(dev), name)
    c = _CONSTS.get(key)
    if c is None:
        c = torch.from_numpy(
            _MP1_MASK if name == "mp1_mask" else _BIT).to(dev)
        _CONSTS[key] = c
    return c


class _Struct:
    """One canonical structure on one device. Values live in a buffer of
    (slots, rows, 15) int64 limbs: slot 0 the zero register, then the
    canonical inputs, the constants and every def in schedule order (a
    level's mul defs, then its add defs, then its sub defs, contiguous).
    Each level gathers its operands with one index_select a unit and
    writes its results into their slots: reads see only earlier levels'
    defs, as the interpreter's reads see the register file before the
    step."""

    def __init__(self, body: Dict, dev):
        self.n_in = body["n_in"]
        self.n_const = body["n_const"]
        base = 1 + self.n_in + self.n_const

        def slot(ref):
            tag, i = ref
            if tag == "z":
                return 0
            if tag == "i":
                return 1 + i
            if tag == "c":
                return 1 + self.n_in + i
            return base + i

        as_t = lambda xs: torch.as_tensor(xs, dtype=torch.int64, device=dev)
        self.levels = []
        d = base
        for mul_ops, add_ops, sub_ops in body["levels"]:
            nm, na, ns = len(mul_ops), len(add_ops), len(sub_ops)
            lin = add_ops + sub_ops
            self.levels.append((
                d, nm,
                as_t([slot(o[0]) for o in mul_ops]) if nm else None,
                as_t([slot(o[1]) for o in mul_ops]) if nm else None,
                na, ns,
                as_t([slot(o[0]) for o in lin] + [slot(o[1]) for o in lin])
                if lin else None,
            ))
            d += nm + na + ns
        self.n_slots = d
        self.out_slots = as_t([base + i for i in body["out"]])
        self.n_out = len(body["out"])

    def core(self, S, in_idx, consts, boundary_idx):
        """(m_in, rows, 15) carry -> (m_out, rows, 15) carry of one
        instance: the instance's tables are tensors the graph reads at
        replay, so one capture serves every instance."""
        rows = S.shape[1]
        L = fq.NUM_LIMBS
        env = S.new_empty((self.n_slots, rows, L))
        env[0] = 0
        if self.n_in:
            torch.index_select(S, 0, in_idx, out=env[1:1 + self.n_in])
        if self.n_const:
            env[1 + self.n_in:1 + self.n_in + self.n_const] = \
                consts[:, None, :]
        mp1_mask = _const(S.device, "mp1_mask")
        for d, nm, ma, mb, na, ns, lin_idx in self.levels:
            if nm:
                env[d:d + nm] = fq.mont_mul(env.index_select(0, ma),
                                            env.index_select(0, mb))
                d += nm
            if lin_idx is not None:
                n = na + ns
                g = env.index_select(0, lin_idx)
                la, lb = g[:n], g[n:]
                if ns:
                    lb[na:] = mp1_mask - lb[na:]
                _carry_fixed(la + lb, out=env[d:d + n])
        outs = env.index_select(0, self.out_slots)
        return torch.cat([outs, S], 0).index_select(0, boundary_idx)


_STRUCTS: Dict[tuple, _Struct] = {}  # (struct key, device) -> _Struct
_STRUCTS_LOCK = threading.Lock()


def _struct(key: str, body: Dict, dev) -> _Struct:
    with _STRUCTS_LOCK:
        st = _STRUCTS.get((key, str(dev)))
        if st is None:
            st = _STRUCTS[(key, str(dev))] = _Struct(body, dev)
        return st


def _run_segment(st: _Struct, kind: str, S, tables):
    """One segment on its tables: a step (one instance) or a scan block
    (its instances in sequence)."""
    in_idx, consts, b_idx = tables
    if kind == "step":
        return st.core(S, in_idx, consts, b_idx)
    for j in range(in_idx.shape[0]):
        S = st.core(S, in_idx[j], consts[j], b_idx[j])
    return S


class _Graph:
    """One unit captured on the card: static carry and table buffers, the
    graph, its static output and the kernel launches it holds."""

    def __init__(self, st: _Struct, kind: str, S_shape, table_shapes, dev,
                 stream):
        from . import cuda_fq  # the CUDA build: on the card only

        self.S = torch.zeros(S_shape, dtype=torch.int64, device=dev)
        # zero tables are valid indices, so nothing the capture records
        # can read out of bounds whatever runs first
        self.tables = tuple(torch.zeros(s, dtype=torch.int64, device=dev)
                            for s in table_shapes)
        self.graph, self.out, self.launches = cuda_fq.capture(
            lambda: _run_segment(st, kind, self.S, self.tables), stream)

    def run(self, S, tables):
        from . import cuda_fq

        self.S.copy_(S)
        for dst, src in zip(self.tables, tables):
            dst.copy_(src)
        self.graph.replay()
        cuda_fq.count_replay(self.launches)
        return self.out


# (unit key, rows, stream key) -> _Graph. Module-level on purpose: a
# structure captured for one program serves every program whose canonical
# form matches. _BUILD_LOCK serializes captures, so a background warm and
# a foreground call never build one unit twice; a stream's lock is held
# from a run's first replay to its output's copy, because the graphs'
# static buffers are shared by every run on that stream.
_GRAPHS: Dict[tuple, _Graph] = {}
_BUILT_CPU = set()  # the same keys on the CPU, where a unit is eager code
_BUILD_LOCK = threading.Lock()
_STREAM_LOCKS: Dict[tuple, threading.Lock] = {}
_KERNELS_WARM = set()  # devices whose op kernels have run once


def _stream_lock(stream_key) -> threading.Lock:
    with _BUILD_LOCK:
        return _STREAM_LOCKS.setdefault(stream_key, threading.Lock())


def _warm_kernels(dev, stream) -> None:
    """Run every kind of op a unit holds once, eagerly, on ``stream``
    before the first capture on ``dev``: the first launch of a kernel may
    load its module, which a capture must not do."""
    if str(dev) in _KERNELS_WARM:
        return
    body = {"levels": [[[[("i", 0), ("i", 1)]], [[("i", 0), ("c", 0)]],
                        [[("d", 0), ("z", 0)]]]],
            "out": [0, 1, 2], "n_in": 2, "n_const": 1}
    st = _Struct(body, dev)
    with torch.cuda.stream(stream):
        S = torch.ones((2, 1, fq.NUM_LIMBS), dtype=torch.int64, device=dev)
        st.core(S, torch.arange(2, device=dev),
                torch.ones((1, fq.NUM_LIMBS), dtype=torch.int64, device=dev),
                torch.arange(3, device=dev))
    stream.synchronize()
    _KERNELS_WARM.add(str(dev))


# ---------------------------------------------------------------------------
# the per-program executor
# ---------------------------------------------------------------------------


def _const_block(vals: List[int]) -> np.ndarray:
    block = np.zeros((len(vals), fq.NUM_LIMBS), dtype=np.int64)
    for i, v in enumerate(vals):
        block[i] = fq.to_mont_int(v).astype(np.int64)
    return block


# "cuda" and "cuda:0" name one card, and the per-device caches key on the
# name: every key takes the device with its index
_canon = torch_env.canonical


def shape_sig(batch_shape, device) -> tuple:
    """An execution's signature for routing and warming: (rows, stream
    key), the stream key (device index, stream) of the caller's current
    stream on the card and None on the CPU."""
    rows = int(math.prod(int(d) for d in batch_shape))
    dev = torch.device(device)
    if dev.type != "cuda":
        return (rows, None)
    s = torch.cuda.current_stream(dev)
    return (rows, (s.device.index, s.cuda_stream))


def mesh_shape_sig(rows: int, mesh) -> tuple:
    """A sharded execution's signature: ("mesh", each slot's signature
    (its rows, its device and this thread's stream of it))."""
    block = rows // mesh.size
    sigs = []
    for slot in mesh.slots:
        with slot.context():
            sigs.append(shape_sig((block,), slot.device))
    return ("mesh",) + tuple(sigs)


class FusedProgram:
    """The fused artifact of one assembled Program: its structural plan,
    its segments (``step``: one instance through its structure; ``scan``:
    a run of same-structure instances) with their instance tables, and the
    signatures (rows, stream) whose units are built."""

    def __init__(self, program, plan: Dict):
        self.program = program
        self.plan = plan
        self.seen_shapes = set()  # signatures built and run
        self.compile_s: Dict[tuple, float] = {}  # signature -> build secs
        self._structs = plan["structs"]
        self._instances = instances = plan["chunks"]
        self._n_inputs = len(plan["inputs"])
        self._final_idx = None
        if not instances:
            # zero scheduled steps: outputs select straight off the inputs
            pos = {r: i for i, r in enumerate(plan["inputs"])}
            self._final_idx = np.asarray(
                [pos[r] for r in plan["outputs"]], dtype=np.int64)
        tables = [
            (np.asarray(c["in_idx"], dtype=np.int64),
             _const_block(c["consts"]),
             np.asarray(c["boundary_idx"], dtype=np.int64))
            for c in instances
        ]
        min_run = superop_min_run(plan) if dedup_enabled() else 0
        segments = []  # (kind, first instance, host tables, length)
        for seg in vm_analysis.scan_blocks(instances, min_run):
            if seg[0] == "step":
                segments.append(("step", seg[1], tables[seg[1]], 1))
            else:
                ci, length = seg[1], seg[2]
                stacks = tuple(
                    np.stack([tables[ci + j][t] for j in range(length)])
                    for t in range(3))
                segments.append(("scan", ci, stacks, length))
        self._segments = segments
        self._dev_tables: Dict[str, List[tuple]] = {}
        self.struct_stats = {
            "chunks": len(instances),
            "distinct_structs": len(self._structs),
            "window": plan.get("window"),
            "period": plan.get("period"),
            "resync": plan.get("resync", False),
            "superop_segments": sum(1 for s in segments if s[0] == "scan"),
        }

    def _tables_on(self, dev) -> List[tuple]:
        key = str(dev)
        if key not in self._dev_tables:
            self._dev_tables[key] = [
                tuple(torch.from_numpy(t).to(dev) for t in seg[2])
                for seg in self._segments]
        return self._dev_tables[key]

    def _unit_key(self, seg, rows: int, stream_key) -> tuple:
        inst = self._instances[seg[1]]
        width = inst["m_out"] if seg[0] == "step" else seg[3]
        return (seg[0], inst["struct"], inst["m_in"], width, rows,
                stream_key)

    def warm(self, sig: tuple, dev) -> float:
        """Build every unit of one signature: on the card, capture each
        unit's graph (on this thread's own stream, for replay on the
        signature's stream); on the CPU, upload the structure's index
        tensors. A unit already built, by this program or another sharing
        the structure, is a ``vm/structural_hit``; a new one a
        ``vm/structural_miss``. Returns the wall seconds (0.0 when the
        signature is already built)."""
        if sig in self.compile_s:
            return 0.0
        dev = _canon(dev)
        rows, stream_key = sig
        t0 = time.perf_counter()
        hits = misses = 0
        tables = self._tables_on(dev)
        for seg, tabs in zip(self._segments, tables):
            inst = self._instances[seg[1]]
            struct = inst["struct"]
            key = self._unit_key(seg, rows, stream_key)
            with _BUILD_LOCK:
                built = key in (_GRAPHS if stream_key else _BUILT_CPU)
                if not built:
                    tu = time.perf_counter()
                    st = _struct(struct, self._structs[struct], dev)
                    if stream_key:
                        stream = torch.cuda.current_stream(dev)
                        _warm_kernels(dev, stream)
                        _GRAPHS[key] = _Graph(
                            st, seg[0], (inst["m_in"], rows, fq.NUM_LIMBS),
                            [tuple(t.shape) for t in tabs], dev, stream)
                        _bump(captures=1)
                    else:
                        _BUILT_CPU.add(key)
                    _BUILT_STRUCTS.add(struct)
                    _flight_note("structural_miss", unit=seg[0],
                                 struct=struct[:12],
                                 seconds=round(time.perf_counter() - tu, 4))
            if built:
                hits += 1
                _flight_note("structural_hit", unit=seg[0],
                             struct=struct[:12])
            else:
                misses += 1
        _bump(struct_hits=hits, struct_misses=misses)
        dt = time.perf_counter() - t0
        self.compile_s[sig] = dt
        _export_gauges()
        _flight_note("fused_warm", rows=rows, units=len(self._segments),
                     struct_hits=hits, struct_misses=misses,
                     seconds=round(dt, 4))
        return dt

    def run(self, stacked: np.ndarray, dev) -> torch.Tensor:
        """(rows, n_in, 15) uint64 canonical inputs -> (rows, n_out, 15)
        int64 outputs on ``dev``, computed on the caller's current stream
        and synchronized with it."""
        rows = stacked.shape[0]
        dev = _canon(dev)
        sig = shape_sig((rows,), dev)
        S = fq.limbs_from_numpy(stacked, dev).transpose(0, 1).contiguous()
        if self._final_idx is not None:
            return S.index_select(
                0, torch.from_numpy(self._final_idx).to(dev)).transpose(0, 1)
        self.warm(sig, dev)
        tables = self._tables_on(dev)
        if sig[1] is None:
            for seg, tabs in zip(self._segments, tables):
                inst = self._instances[seg[1]]
                st = _struct(inst["struct"], self._structs[inst["struct"]],
                             dev)
                S = _run_segment(st, seg[0], S, tabs)
            return S.transpose(0, 1)
        with _stream_lock(sig[1]):
            for seg, tabs in zip(self._segments, tables):
                S = _GRAPHS[self._unit_key(seg, rows, sig[1])].run(S, tabs)
            out = S.transpose(0, 1).contiguous()  # leaves the static buffer
            torch.cuda.current_stream(dev).synchronize()
        return out


# id(program) -> FusedProgram; the values hold their programs, so a live
# entry's id is never recycled by another Program
_FUSED: Dict[int, FusedProgram] = {}
_FUSED_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# disk cache: per-program plans referencing shared structure entries
# ---------------------------------------------------------------------------


def _plan_cache_path(program) -> Optional[str]:
    """Disk path of this program's plan, or None for a program without a
    cache identity (assembled outside ``bls_backend._program``)."""
    meta = program.meta or {}
    key = meta.get("fused_key")
    if not key:
        return None
    kind, k, fold, fp = key
    from . import bls_backend as bb

    return os.path.join(
        bb._vm_cache_dir(),
        f"fusedplan_l{LOWERING_VERSION}_v{bb._VM_CACHE_VERSION}_{fp}"
        f"_{kind}_k{k}_f{fold}_w{meta.get('w_mul', 0)}x"
        f"{meta.get('w_lin', 0)}_p{program.n_steps}_c{chunk_steps()}.pkl",
    )


def _struct_cache_path(struct: str, cache_dir: str = None) -> str:
    if cache_dir is None:
        from . import bls_backend as bb

        cache_dir = bb._vm_cache_dir()
    return os.path.join(
        cache_dir, f"fusedstruct_l{LOWERING_VERSION}_{struct}.pkl")


def _touch(path: str) -> None:
    try:
        os.utime(path)  # prune evicts by idle age
    except OSError:
        pass


def _load_plan(program) -> Optional[Dict]:
    """The disk-cached plan of ``program`` at the current chunk setting,
    its structures loaded into ``plan["structs"]``, or None (absent,
    unreadable, another policy or chunking, or a referenced structure
    missing or corrupted: the caller re-derives, never errors)."""
    import pickle

    path = _plan_cache_path(program)
    if path is None or not dedup_enabled():
        return None
    try:
        with open(path, "rb") as fh:
            plan = pickle.load(fh)
        if (plan.get("format") != 2
                or plan.get("policy") != PLAN_POLICY
                or plan.get("sched_steps") is None
                or plan.get("chunk_steps") != chunk_steps()):
            return None
        structs: Dict[str, Dict] = {}
        for ref in plan.get("struct_refs", ()):
            spath = _struct_cache_path(ref)
            with open(spath, "rb") as fh:
                body = pickle.load(fh)
            if not isinstance(body, dict) or "levels" not in body:
                return None  # corrupted structure entry: re-derive
            structs[ref] = body
            _touch(spath)
        if not {c["struct"] for c in plan.get("chunks", ())} <= set(structs):
            return None
        plan["structs"] = structs
        _touch(path)
        return plan
    except Exception:
        return None


def _store_plan(program, plan: Dict) -> None:
    """Persist the plan (instance tables and measured pair) and each
    structure body it references as a shared ``fusedstruct_`` entry (the
    bodies are canonical, so rewriting one is idempotent and heals a
    corrupted entry)."""
    import pickle

    path = _plan_cache_path(program)
    if path is None or not dedup_enabled():
        return
    tag = f"{os.getpid()}.{threading.get_ident()}"
    try:
        slim = {k: v for k, v in plan.items() if k != "structs"}
        slim["struct_refs"] = sorted(plan.get("structs", {}))
        for ref, body in plan.get("structs", {}).items():
            spath = _struct_cache_path(ref)
            tmp = f"{spath}.{tag}.tmp"
            with open(tmp, "wb") as fh:
                pickle.dump(body, fh)
            os.replace(tmp, spath)
        tmp = f"{path}.{tag}.tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(slim, fh)
        os.replace(tmp, path)
    except Exception:
        pass  # the disk cache is an optimization only


def _derive_plan(program) -> Dict:
    """The structural plan from scratch through
    ``vm_analysis.plan_structures``, the pipeline vmlint reports on."""
    base = chunk_steps()
    plan_src, sp, info = vm_analysis.plan_structures(
        program, base, dedup=dedup_enabled(), min_run=_superop_env())
    return {
        "format": 2,
        "policy": PLAN_POLICY,
        "sched_steps": plan_src["sched_steps"],
        "chunk_steps": base,
        "window": info["window"],
        "period": info["period"],
        "resync": info["resync"],
        "inputs": plan_src["inputs"],
        "outputs": plan_src["outputs"],
        "n_mul": plan_src["n_mul"],
        "n_lin": plan_src["n_lin"],
        "chunks": sp["instances"],
        "structs": sp["structs"],
        "measured": {},
    }


def _exec_stats(program) -> Dict:
    st = getattr(program, "_exec_stats", None)
    if st is None:
        st = program._exec_stats = {}
    return st


def _seed_stats_from_plan(program, plan: Dict) -> None:
    """Adopt the plan's persisted warm ms/row into the in-process ledger
    (keeping any better number this process measured): a fresh process's
    ``auto`` route then serves the winner a past run measured."""
    meas = plan.get("measured")
    if not isinstance(meas, dict):
        return
    st = _exec_stats(program)
    for key in ("interp_ms_row", "fused_ms_row"):
        v = meas.get(key)
        if v is not None and (st.get(key) is None or v < st[key]):
            st[key] = float(v)


def fused_program(program, plan: Dict = None) -> FusedProgram:
    """The fused artifact of ``program`` (load or derive its plan, cut its
    segments; units are built at the first run or warm of a signature)."""
    with _FUSED_LOCK:
        fp = _FUSED.get(id(program))
        if fp is not None:
            return fp
        t0 = time.perf_counter()
        if plan is None:
            plan = _load_plan(program)
        if plan is None:
            plan = _derive_plan(program)
            _store_plan(program, plan)
        _seed_stats_from_plan(program, plan)
        fp = _FUSED[id(program)] = FusedProgram(program, plan)
    _bump(programs=1)
    _export_gauges()
    _flight_note(
        "fused_compile", steps=int(program.n_steps),
        chunks=len(plan["chunks"]), structs=len(plan.get("structs", ())),
        window=plan.get("window"),
        plan_seconds=round(time.perf_counter() - t0, 4))
    return fp


# ---------------------------------------------------------------------------
# background warm: build missing signatures off the serving path
# ---------------------------------------------------------------------------

_BG_LOCK = threading.Lock()
_BG_QUEUE: deque = deque()
_BG_PENDING = set()
_BG_FAILED = set()  # keys whose warm raised: never retried
_BG_THREAD: Optional[threading.Thread] = None
_BG_IDLE = threading.Condition(_BG_LOCK)


def _sig_device(sig: tuple) -> torch.device:
    return (torch.device("cpu") if sig[1] is None
            else torch.device("cuda", sig[1][0]))


def _bg_worker() -> None:
    """The warm thread: it captures on a stream of its own
    (``cuda_fq.capture`` takes the thread's side stream), for replay on
    the requesting call's stream."""
    while True:
        with _BG_LOCK:
            if not _BG_QUEUE:
                _BG_IDLE.notify_all()
                _BG_IDLE.wait(timeout=5.0)
                if not _BG_QUEUE:
                    continue
            program, sig = _BG_QUEUE.popleft()
        key = (id(program), sig)
        try:
            dt = fused_program(program).warm(sig, _sig_device(sig))
            fused_program(program).seen_shapes.add(sig)
            _flight_note("bg_warm_ready", rows=sig[0], seconds=round(dt, 4),
                         steps=int(program.n_steps))
        except Exception as e:
            # a warm that fails once fails again: the signature stays on
            # the interpreter for the process's lifetime
            with _BG_LOCK:
                _BG_FAILED.add(key)
            note_fallback(program, e)
        finally:
            with _BG_LOCK:
                _BG_PENDING.discard(key)
                if not _BG_QUEUE:
                    _BG_IDLE.notify_all()


def _bg_enqueue(program, sig: tuple) -> None:
    global _BG_THREAD
    key = (id(program), sig)
    with _BG_LOCK:
        if key in _BG_PENDING or key in _BG_FAILED:
            return
        _BG_PENDING.add(key)
        _BG_QUEUE.append((program, sig))
        if _BG_THREAD is None or not _BG_THREAD.is_alive():
            _BG_THREAD = threading.Thread(
                target=_bg_worker, name="vm-fused-bg-warm", daemon=True)
            _BG_THREAD.start()
        _BG_IDLE.notify_all()
    _flight_note("bg_warm_queued", rows=sig[0], steps=int(program.n_steps))


def bg_warm_drain(timeout: float = 60.0) -> bool:
    """Wait until the background-warm queue is empty and idle (tests and
    the cold bench; serving code never blocks on it)."""
    deadline = time.monotonic() + timeout
    with _BG_LOCK:
        while _BG_QUEUE or _BG_PENDING:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            _BG_IDLE.wait(timeout=min(0.25, remaining))
    return True


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def use_fused(program, mode: str = None, shape_sig: tuple = None) -> bool:
    """Route decision for one execution. ``fused`` always takes this
    lowering (building units on demand); ``auto`` only when the measured
    warm ms/row pair (seeded once a Program from its disk plan) says
    fused wins and, given a ``shape_sig`` (what ``vm.execute`` passes),
    the signature's units are already built, so that ``auto`` never pays
    a cold build inside a call. A missing signature is enqueued for the
    background warm under CONSENSUS_SPECS_TPU_VM_WARM_BG=1; with no fused
    measurement at all, auto stays on the interpreter."""
    if mode is None:
        mode = exec_mode()
    if mode == "interp":
        return False
    if mode == "fused":
        return True
    st = getattr(program, "_exec_stats", None) or {}
    f, i = st.get("fused_ms_row"), st.get("interp_ms_row")
    if (f is None or i is None) and not getattr(
            program, "_fused_plan_checked", False):
        program._fused_plan_checked = True
        try:
            plan = _load_plan(program)
            meas = (plan.get("measured") or {}) if plan else {}
            if (meas.get("fused_ms_row") is not None
                    and meas.get("interp_ms_row") is not None):
                fused_program(program, plan=plan)
        except Exception as e:
            # a loadable but malformed plan must not break the decision
            note_fallback(program, e)
        st = getattr(program, "_exec_stats", None) or {}
        f, i = st.get("fused_ms_row"), st.get("interp_ms_row")
    if f is None or i is None or f >= i:
        return False
    if shape_sig is None:
        return True  # shape-independent query (tests, diagnostics)
    fp = _FUSED.get(id(program))
    ready = fp is not None and tuple(shape_sig) in fp.seen_shapes
    # the background warm builds single-device signatures only (as the
    # JAX package's warms no sharded one)
    if not ready and _bg_warm_enabled() and shape_sig[0] != "mesh":
        _bg_enqueue(program, tuple(shape_sig))
    return ready


def run_fused(program, stacked: np.ndarray, device, mesh=None):
    """Execute through the fused lowering: (rows, n_in, 15) uint64 inputs
    -> ((rows, n_out, 15) int64 outputs, compile_inclusive). The flag
    marks a first run at this signature, whose wall time includes
    building units and must not enter the warm ms/row ledger. The card is
    synchronized before the return, inside the caller's fallback net and
    timer. Without ``mesh`` the outputs are on ``device``; with one, slot
    i's contiguous block of rows runs through that slot's units (keyed by
    its device, this thread's stream of it and the thread, as every
    unit) and the outputs are gathered in slot order on the CPU."""
    fp = fused_program(program)
    if mesh is not None:
        sig = mesh_shape_sig(stacked.shape[0], mesh)
        compile_inclusive = sig not in fp.seen_shapes
        block = stacked.shape[0] // mesh.size
        outs = []
        for slot, slot_sig in zip(mesh.slots, sig[1:]):
            with slot.context():
                lo = slot.index * block
                outs.append(fp.run(stacked[lo:lo + block], slot.device).cpu())
            fp.seen_shapes.add(slot_sig)
        out = torch.cat(outs)
        fp.seen_shapes.add(sig)
        _bump(executions=1)
        _export_gauges()
        return out, compile_inclusive
    dev = torch.device(device)
    sig = shape_sig((stacked.shape[0],), dev)
    compile_inclusive = sig not in fp.seen_shapes
    out = fp.run(stacked, dev)
    fp.seen_shapes.add(sig)
    _bump(executions=1)
    _export_gauges()
    return out, compile_inclusive


def warm_fused(program, batch_shape=(), device=None) -> float:
    """Build the fused units of one batch shape on ``device`` (None: the
    card, for replay on the caller's current stream; "cpu": the plain
    versions) and return the wall seconds (0.0 when built already);
    ``auto`` serves fused at a signature only after a call like this, a
    pinned ``fused`` call or the background warm has built it."""
    dev = resolve_device(device)
    fp = fused_program(program)
    sig = shape_sig(batch_shape, dev)
    dt = fp.warm(sig, dev)
    fp.seen_shapes.add(sig)
    return dt


def note_execution(program, path: str, seconds: float, rows: int,
                   compile_inclusive: bool = False) -> None:
    """Feed the per-program measured ms/row ledger ``auto`` reads: the
    process-lifetime minimum per path (first runs at a signature that
    built units are left out). A gain of more than 10% is also persisted
    into the program's disk plan, which a fresh process consults."""
    if compile_inclusive:
        return
    try:
        st = _exec_stats(program)
        key = f"{path}_ms_row"
        ms = seconds * 1e3 / max(1, rows)
        prev = st.get(key)
        if prev is not None and ms >= prev:
            return
        st[key] = ms
        fp = _FUSED.get(id(program))
        if fp is not None and (prev is None or ms < prev * 0.9):
            meas = dict(fp.plan.get("measured") or {})
            meas[key] = round(ms, 4)
            for other in ("interp_ms_row", "fused_ms_row"):
                if other != key and st.get(other) is not None:
                    cur = meas.get(other)
                    if cur is None or st[other] < cur:
                        meas[other] = round(st[other], 4)
            fp.plan["measured"] = meas
            _store_plan(program, fp.plan)
    except Exception:
        pass  # the ledger is routing advice, never a failure source


def note_fallback(program, err: BaseException) -> None:
    """A fused attempt failed: count it and journal a
    ``vm/fused_fallback`` flight event; the interpreter serves the call."""
    _bump(fallbacks=1)
    _export_gauges()
    _flight_note(
        "fused_fallback",
        steps=int(program.n_steps),
        error=f"{type(err).__name__}: {err}"[:200],
    )


def reset_fused_state() -> None:
    """Test hook: drop the fused artifacts, built units, the background
    queue and the counters (gauges re-zeroed)."""
    with _FUSED_LOCK:
        _FUSED.clear()
    with _BUILD_LOCK:
        _GRAPHS.clear()
        _BUILT_CPU.clear()
        _BUILT_STRUCTS.clear()
    with _STRUCTS_LOCK:
        _STRUCTS.clear()
    with _BG_LOCK:
        _BG_QUEUE.clear()
        _BG_PENDING.clear()
        _BG_FAILED.clear()
    with _COUNT_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
    _export_gauges()
