"""SIMD field-ALU virtual machine: assembler and executor of the port.

The counterpart of consensus_specs_tpu/ops/vm.py. A program is a
straight-line field computation (``Prog``) scheduled onto a fixed two-unit
ALU and assembled into instruction tensors (``Program``):

  - MUL unit: W_m lanes of batched Montgomery multiply,
  - LIN unit: W_l lanes of add / borrowless subtract (+ carry normalize),

with the schedule — which registers each lane reads and writes at each
step — as data. The assembler (bound tracking, the bucketed list
scheduler, the linear-scan register allocator) is a copy of the JAX
package's and emits the same tensors bit for bit. Scheduling and
allocation run in the native kernel ``csrc/vm_sched.c`` (built with the
host C compiler at first use into ``_build/``), or, where no compiler is
found, in its pure-Python twin ``_schedule_alloc_py`` after a one-time
warning; ``assemble_legacy`` is the reference list scheduler both are
held to.

``execute`` runs a program on a (rows, n_regs, 15) int64 register file: on
the CUDA card every step is one launch of the fused step kernel
(ops/cuda_step.py, csrc/vm_step.cu); on the CPU each step runs the plain
PyTorch version, ``_vm_step_plain``. ``CONSENSUS_SPECS_TPU_VM_EXEC`` may
route a call through the fused straight-line lowering instead
(ops/vm_compile.py).

Register values are loose Montgomery residues (ops/fq.py conventions). The
assembler tracks magnitude bounds per value and auto-inserts compress
multiplies, so lazy reduction is handled statically at assembly time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_step, fq

# value-magnitude bounds for lazy reduction (limb-level overflow is
# impossible by representation: limbs are < 2^28 after every carry)
_B_SUB_B = fq.MP  # subtrahend must not exceed the MP shift
_B_SUB_A = 1 << 419  # minuend headroom: a + MP < 2^420
_B_CAP = 1 << 420  # register capacity (15 x 28-bit limbs)

_MUL, _ADD, _SUB = 0, 1, 2

_PKG = Path(__file__).resolve().parents[1]
_SCHED_SRC = _PKG / "csrc" / "vm_sched.c"
BUILD_DIR = _PKG / "_build"

_UNLOADED = object()
# ctypes handle of the native scheduler, None where it cannot be built or
# loaded, _UNLOADED until the first assembly asks for it
_NATIVE_SCHED = _UNLOADED
_NATIVE_WARNED = False


def native_library_path() -> Path:
    digest = hashlib.sha256(_SCHED_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libvmsched_{digest}.so"


def _build_native(so: Path) -> bool:
    """Compile csrc/vm_sched.c with the host C compiler to a temporary
    path, then os.replace onto the final name, so that another process
    never loads a library half written."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.%d.tmp" % os.getpid())
    try:
        subprocess.run(
            [cc, "-O2", "-fPIC", "-shared", "-o", str(tmp), str(_SCHED_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load_native_sched():
    """ctypes handle to the native scheduling + allocation kernel, built
    on first use, or None (no compiler, a failed build, or a library
    without the expected symbol): the pure-Python scheduler is then used,
    bit-identical to it."""
    try:
        so = native_library_path()
        if not so.exists() and not _build_native(so):
            return None
        lib = ctypes.CDLL(str(so))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.vm_schedule_alloc.restype = ctypes.c_int
        lib.vm_schedule_alloc.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p,  # n, kind, a, b
            ctypes.c_int64, ctypes.c_int64,    # w_mul, w_lin
            ctypes.c_int64, i64p,              # n_out, outs
            i64p, i64p, i64p, i64p,            # step, last_use, reg, meta
        ]
        return lib
    except (OSError, AttributeError):
        return None


def native_sched():
    """The native scheduler's handle (built and loaded once a process),
    or None."""
    global _NATIVE_SCHED
    if _NATIVE_SCHED is _UNLOADED:
        _NATIVE_SCHED = _load_native_sched()
    return _NATIVE_SCHED


def _warn_native_missing() -> None:
    """One line on stderr, once a process, when the native scheduler is
    not available: assembly then runs the pure-Python scheduler, a few
    times slower, never an error."""
    global _NATIVE_WARNED
    if native_sched() is None and not _NATIVE_WARNED:
        _NATIVE_WARNED = True
        print(
            "vm: the native scheduler (consensus_specs_tpu_torch/csrc/"
            "vm_sched.c) could not be built or loaded - assembling with "
            "the pure-Python scheduler; a C compiler on the PATH (cc or "
            "gcc) builds it",
            file=sys.stderr,
        )


def _native_schedule_alloc(kind_arr, a_all, b_all, w_mul, w_lin, outputs):
    """Run the native kernel over sanitized int64 IR columns. Returns
    (step, last_use, reg, n_steps, alloc_regs), or None on any failure
    (the caller then runs the Python loops)."""
    lib = native_sched()
    if lib is None:
        return None
    n = kind_arr.size
    step = np.empty(n, dtype=np.int64)
    last_use = np.empty(n, dtype=np.int64)
    reg = np.full(n, -1, dtype=np.int64)
    meta = np.zeros(2, dtype=np.int64)
    outs = np.asarray(outputs, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p(arr):
        return arr.ctypes.data_as(i64p)

    # every buffer stays bound to a local for the duration of the call;
    # all are freshly built C-contiguous int64 arrays
    try:
        rc = lib.vm_schedule_alloc(
            n, p(kind_arr), p(a_all), p(b_all),
            w_mul, w_lin, outs.size, p(outs),
            p(step), p(last_use), p(reg), p(meta),
        )
    except Exception:
        return None
    if rc != 0:
        return None
    return step, last_use, reg, int(meta[0]), int(meta[1])


@dataclass
class _Op:
    kind: int  # _MUL/_ADD/_SUB, -1 input, -2 const
    a: int  # producing op index (const: the payload)
    b: int
    bound: int
    # the schedule, written back by assemble (vm_analysis reads it)
    step: int = -1
    reg: int = -1
    last_use_step: int = -1


class Val:
    """Handle to a symbolic field value inside a Prog."""

    __slots__ = ("prog", "idx")

    def __init__(self, prog: "Prog", idx: int):
        self.prog = prog
        self.idx = idx

    @property
    def bound(self) -> int:
        return self.prog.ops[self.idx].bound

    def __mul__(self, other: "Val") -> "Val":
        return self.prog.mul(self, other)

    def __add__(self, other: "Val") -> "Val":
        return self.prog.add(self, other)

    def __sub__(self, other: "Val") -> "Val":
        return self.prog.sub(self, other)


class Prog:
    """Straight-line field-program builder with bound tracking."""

    def __init__(self):
        self.ops: List[_Op] = []
        self.inputs: List[int] = []  # op indices with kind 'input'
        self.input_names: List[str] = []
        self.consts: Dict[int, int] = {}  # int value -> op idx
        self.outputs: List[int] = []
        self.output_names: List[str] = []
        self._one: Optional[Val] = None
        self._compressed: Dict[int, int] = {}  # op idx -> compressed op idx
        self._cse: Dict[Tuple[int, int, int], int] = {}  # (kind,a,b) -> op idx

    # -- value creation ----------------------------------------------------

    def _push(self, kind, a, b, bound) -> Val:
        """Create an ALU op, CSE-deduplicated (a loop-invariant operand
        re-derived inside a ladder would otherwise sit live in a register
        from step ~0 to its distant consumer). Bounds are a pure function
        of (kind, operand bounds), so the memoized op is exact."""
        if a >= 0 and b >= 0:  # inputs/consts use -1 sentinels: never CSE
            key = (kind, a, b) if (kind == _SUB or a <= b) else (kind, b, a)
            hit = self._cse.get(key)
            if hit is not None:
                return Val(self, hit)
        else:
            key = None
        if bound >= _B_CAP:
            raise AssertionError("assembler bound overflow — missing compress")
        self.ops.append(_Op(kind, a, b, bound))
        v = Val(self, len(self.ops) - 1)
        if key is not None:
            self._cse[key] = v.idx
        return v

    def inp(self, name: str, bound: int = fq.P) -> Val:
        """Runtime input slot. The default ``bound`` declares a canonical
        Montgomery residue (< p); a looser bound makes the tracker insert
        the compress multiplies the magnitude needs."""
        v = self._push(_MUL, -1, -1, bound)
        self.ops[v.idx].kind = -1  # input marker
        self.inputs.append(v.idx)
        self.input_names.append(name)
        return v

    def const(self, value: int) -> Val:
        """Compile-time field constant (plain integer mod p; encoded to
        Montgomery form at program build)."""
        value %= fq.P
        if value in self.consts:
            return Val(self, self.consts[value])
        v = self._push(_MUL, -1, -1, fq.P)
        self.ops[v.idx].kind = -2  # const marker
        self.ops[v.idx].a = value  # stash the payload
        self.consts[value] = v.idx
        return v

    # -- ALU ops -----------------------------------------------------------

    def _raw_mul(self, a: Val, b: Val) -> Val:
        out_bound = (a.bound * b.bound) // fq.R_MONT + fq.P + 1
        return self._push(_MUL, a.idx, b.idx, out_bound)

    def compress(self, v: Val) -> Val:
        """Magnitude reduction: multiply by repr(1) (bound -> < 2^383);
        memoized so repeated consumers share one compress."""
        if v.idx in self._compressed:
            return Val(self, self._compressed[v.idx])
        if self._one is None or self._one.prog is not self:
            self._one = self.const(1)
        out = self._raw_mul(v, self._one)
        self._compressed[v.idx] = out.idx
        return out

    def _fit(self, v: Val, bound: int) -> Val:
        return self.compress(v) if v.bound > bound else v

    def mul(self, a: Val, b: Val) -> Val:
        while (a.bound * b.bound) // fq.R_MONT + fq.P + 1 >= _B_CAP:
            if a.bound >= b.bound:
                a = self.compress(a)
            else:
                b = self.compress(b)
        return self._raw_mul(a, b)

    def add(self, a: Val, b: Val) -> Val:
        if a.bound + b.bound >= _B_CAP:
            a = self.compress(a)
            if a.bound + b.bound >= _B_CAP:
                b = self.compress(b)
        return self._push(_ADD, a.idx, b.idx, a.bound + b.bound)

    def sub(self, a: Val, b: Val) -> Val:
        a = self._fit(a, _B_SUB_A - fq.MP)
        b = self._fit(b, _B_SUB_B)
        return self._push(_SUB, a.idx, b.idx, a.bound + fq.MP)

    def out(self, v: Val, name: str) -> None:
        """Mark a value as a program output (compressed to < 2^382 so hosts
        and epilogues get bounded limbs)."""
        v = self.compress(v)
        self.outputs.append(v.idx)
        self.output_names.append(name)

    # -- static analysis ----------------------------------------------------

    def analyze(self, name: str = "<prog>", **assemble_kwargs):
        """vmlint entry point over the IR: assemble with the given shape
        (annotating every op with step/reg/last-use) and run the whole
        ops/vm_analysis.py pass. Returns the report dict."""
        from . import vm_analysis

        return vm_analysis.analyze_prog(self, name=name, **assemble_kwargs)

    # -- scheduling + register allocation ----------------------------------

    def assemble(
        self,
        w_mul: int = 128,
        w_lin: int = 128,
        pad_steps_to: int = 1,
        pad_regs_to: int = 1,
        annotate: bool = True,
    ) -> "Program":
        """Schedule + allocate with the bucketed incremental scheduler:
        each ALU op lands on the first step >= max(operand steps) + 1 whose
        unit has a free lane, lanes filled in op-creation order (the
        legacy list scheduler's rule, held bit-identical to
        ``assemble_legacy``). `pad_steps_to`/`pad_regs_to` round the step
        count and register-file size up so distinct programs share shapes.
        ``annotate`` writes step/last-use/reg back onto the IR ops
        (vm_analysis reads them); the program cache skips it."""
        _warn_native_missing()
        ops = self.ops
        n = len(ops)
        kind_l = [op.kind for op in ops]
        a_l = [op.a for op in ops]
        b_l = [op.b for op in ops]
        # operand columns are numpy-castable once the const payloads
        # (arbitrary-size field ints stashed in ``a``) are masked out
        if self.consts:
            a_l_safe = a_l[:]  # local copy: never mutate the IR
            for ci in self.consts.values():
                a_l_safe[ci] = 0
        else:
            a_l_safe = a_l
        kind_arr = np.fromiter(kind_l, dtype=np.int64, count=n)
        a_all = np.fromiter(a_l_safe, dtype=np.int64, count=n)
        b_all = np.fromiter(b_l, dtype=np.int64, count=n)

        native = _native_schedule_alloc(
            kind_arr, a_all, b_all, w_mul, w_lin, self.outputs)
        if native is not None:
            step_arr, last_use, reg_arr, n_steps, next_reg = native
        else:
            step_arr, last_use, reg_arr, n_steps, next_reg = (
                self._schedule_alloc_py(kind_l, a_l, b_l, kind_arr, a_all,
                                        b_all, w_mul, w_lin))
        alu_idx = np.flatnonzero(kind_arr >= 0)
        n_alu = int(alu_idx.size)
        a_arr = a_all[alu_idx]
        b_arr = b_all[alu_idx]
        alu_steps = step_arr[alu_idx]
        kind_alu = kind_arr[alu_idx]

        sched_steps = n_steps  # pre-padding schedule length
        n_steps = -(-n_steps // pad_steps_to) * pad_steps_to
        n_regs = next_reg
        # trash registers for idle lanes
        trash_mul = n_regs
        trash_lin = n_regs + w_mul
        n_regs += w_mul + w_lin
        if n_regs < pad_regs_to:
            n_regs = pad_regs_to

        # instruction arrays: lanes are the within-step rank in creation
        # order; idle lanes pre-filled with their trash destination
        # registers (zero sources)
        reg_a = reg_arr.astype(np.int32)
        msa = np.zeros((n_steps, w_mul), dtype=np.int32)
        msb = np.zeros((n_steps, w_mul), dtype=np.int32)
        msd = np.empty((n_steps, w_mul), dtype=np.int32)
        msd[:] = trash_mul + np.arange(w_mul, dtype=np.int32)
        lsa = np.zeros((n_steps, w_lin), dtype=np.int32)
        lsb = np.zeros((n_steps, w_lin), dtype=np.int32)
        lsub = np.zeros((n_steps, w_lin), dtype=bool)
        lsd = np.empty((n_steps, w_lin), dtype=np.int32)
        lsd[:] = trash_lin + np.arange(w_lin, dtype=np.int32)

        is_mul = kind_alu == _MUL
        for unit_sel, (ma, mb, md) in ((is_mul, (msa, msb, msd)),
                                       (~is_mul, (lsa, lsb, lsd))):
            sel = np.flatnonzero(unit_sel)
            if not sel.size:
                continue
            steps_u = alu_steps[sel]
            o = np.argsort(steps_u, kind="stable")
            ss = steps_u[o]
            so = sel[o]
            # lane = rank within the step group (creation order preserved)
            group_start = np.r_[0, np.flatnonzero(np.diff(ss)) + 1]
            lanes = np.arange(ss.size, dtype=np.int64)
            lanes -= np.repeat(group_start,
                               np.diff(np.r_[group_start, ss.size]))
            ma[ss, lanes] = reg_a[a_arr[so]]
            mb[ss, lanes] = reg_a[b_arr[so]]
            md[ss, lanes] = reg_a[alu_idx[so]]
            if md is lsd:
                lsub[ss, lanes] = kind_alu[so] == _SUB

        const_payload = {
            int(reg_arr[idx]): ops[idx].a for idx in self.consts.values()
        }
        n_mul = int(is_mul.sum())
        if annotate:
            # the schedule written back onto the IR; a fresh assemble
            # rewrites all three, so an earlier shape cannot bleed through
            step_l = step_arr.tolist()
            last_l = last_use.tolist()
            reg_l = reg_arr.tolist()
            for i, op in enumerate(ops):
                op.step = step_l[i]
                op.last_use_step = last_l[i]
                op.reg = reg_l[i]
        return Program(
            n_regs=n_regs,
            instr=(msa, msb, msd, lsa, lsb, lsub, lsd),
            input_regs=np.asarray([int(reg_arr[i]) for i in self.inputs],
                                  dtype=np.int32),
            input_names=list(self.input_names),
            output_regs=np.asarray([int(reg_arr[i]) for i in self.outputs],
                                   dtype=np.int32),
            output_names=list(self.output_names),
            const_regs=const_payload,
            n_steps=n_steps,
            # schedule metadata: vm_analysis.program_stats and
            # lowering_plan read it off cache-loaded programs whose IR is
            # gone
            meta={
                "sched_steps": sched_steps,
                "n_mul": n_mul,
                "n_lin": n_alu - n_mul,
                "alloc_regs": next_reg,
                "trash_mul": trash_mul,
                "trash_lin": trash_lin,
                "w_mul": w_mul,
                "w_lin": w_lin,
            },
        )

    def _schedule_alloc_py(self, kind_l, a_l, b_l, kind_arr, a_all, b_all,
                           w_mul, w_lin):
        """Scheduling + allocation (a copy of the JAX package's pure-Python
        scheduler, bit-identical to it and to csrc/vm_sched.c). Returns
        (step, last_use, reg, n_steps, alloc_regs)."""
        n = len(kind_l)

        # 1) bucketed list scheduling: per-unit lane-fill counters plus a
        #    union-find over steps ("first step >= t with a free lane"); a
        #    full step's root points one past itself
        step: List[int] = [-1] * n
        fill0: List[int] = []
        fill1: List[int] = []
        nxt0: List[int] = []
        nxt1: List[int] = []
        ln0 = ln1 = 0
        for i, (k, ai, bi) in enumerate(zip(kind_l, a_l, b_l)):
            if k < 0:
                continue  # input/const: defined before step 0
            sa = step[ai]
            sb = step[bi]
            t = (sa if sa >= sb else sb) + 1
            if k == 0:  # _MUL
                f, nx, ln, width = fill0, nxt0, ln0, w_mul
            else:
                f, nx, ln, width = fill1, nxt1, ln1, w_lin
            if t >= ln:
                while ln <= t:
                    nx.append(ln)
                    f.append(0)
                    ln += 1
                r = t
            else:
                # find the root (first candidate free step >= t),
                # path-compressing the chain walked
                r = t
                x = nx[r]
                if x != r:
                    chain = []
                    ap_c = chain.append
                    while True:
                        ap_c(r)
                        r = x
                        if r == ln:
                            nx.append(ln)
                            f.append(0)
                            ln += 1
                            break
                        x = nx[r]
                        if x == r:
                            break
                    for c in chain:
                        nx[c] = r
            if k == 0:
                ln0 = ln
            else:
                ln1 = ln
            cnt = f[r] + 1
            f[r] = cnt
            if cnt == width:
                nx[r] = r + 1
            step[i] = r

        n_steps = ln0 if ln0 >= ln1 else ln1

        # 2) liveness: last step at which each value is read
        step_arr = np.fromiter(step, dtype=np.int64, count=n)
        alu_idx = np.flatnonzero(kind_arr >= 0)
        alu_steps = step_arr[alu_idx]
        last_use = np.full(n, -1, dtype=np.int64)
        np.maximum.at(last_use, a_all[alu_idx], alu_steps)
        np.maximum.at(last_use, b_all[alu_idx], alu_steps)
        if self.outputs:
            last_use[np.asarray(self.outputs)] = n_steps + 1  # live to end

        # 3) linear-scan register allocation (reg 0 = always-zero scratch
        #    source for idle lanes): defs claim the most recently freed
        #    register (LIFO); a register is freed only after the step of
        #    its value's last use, so no step writes a register it reads
        reg_l = [-1] * n
        next_reg = 1
        free: List[int] = []
        expiry: List[List[int]] = [[] for _ in range(n_steps + 2)]

        last_l = last_use.tolist()
        # inputs and constants in creation order, defined "before step 0";
        # a dead input/const is never freed
        for i in sorted(self.inputs + list(self.consts.values())):
            if free:
                r = free.pop()
            else:
                r = next_reg
                next_reg += 1
            reg_l[i] = r
            lu = last_l[i]
            if lu >= 0:
                expiry[lu].append(r)
        # ALU defs in (step, creation) order
        alloc_order = np.argsort(alu_steps, kind="stable")
        order = alu_idx[alloc_order].tolist()
        order_steps = alu_steps[alloc_order].tolist()
        order_last = last_use[alu_idx][alloc_order].tolist()
        cur = 0
        free_pop = free.pop
        free_ext = free.extend
        for i, t, lu in zip(order, order_steps, order_last):
            while cur < t:  # free everything expiring strictly before t
                e = expiry[cur]
                if e:
                    free_ext(e)
                cur += 1
            if free:
                r = free_pop()
            else:
                r = next_reg
                next_reg += 1
            reg_l[i] = r
            expiry[lu if lu >= 0 else t].append(r)

        reg_arr = np.fromiter(reg_l, dtype=np.int64, count=n)
        return step_arr, last_use, reg_arr, n_steps, next_reg

    def assemble_legacy(
        self,
        w_mul: int = 128,
        w_lin: int = 128,
        pad_steps_to: int = 1,
        pad_regs_to: int = 1,
    ) -> "Program":
        """The reference list scheduler (a copy of the JAX package's), kept
        as the equivalence oracle: the tests hold ``assemble`` (native and
        pure-Python) to bit-identical instruction tensors, register maps
        and metadata for every registry program. No production path calls
        it."""
        ops = self.ops
        n = len(ops)
        is_alu = [op.kind in (_MUL, _ADD, _SUB) for op in ops]

        # re-assembly must start clean: step/last-use/reg are schedule
        # outputs, and a previous assemble at a different shape would
        # otherwise bleed through the max() accumulation below (stale live
        # ranges -> corrupted liveness and allocation)
        for op in ops:
            op.step = -1
            op.last_use_step = -1
            op.reg = -1

        # 1) list-schedule ALU ops into steps
        unit_of = [0 if op.kind == _MUL else 1 for op in ops]
        width = (w_mul, w_lin)
        fill: List[List[int]] = [[], []]  # per unit, per step lane count

        for i, op in enumerate(ops):
            if not is_alu[i]:
                continue
            earliest = 0
            for src in (op.a, op.b):
                s = ops[src].step
                if s >= 0:
                    earliest = max(earliest, s + 1)
            u = unit_of[i]
            t = earliest
            f = fill[u]
            while True:
                while len(f) <= t:
                    f.append(0)
                if f[t] < width[u]:
                    f[t] += 1
                    op.step = t
                    break
                t += 1

        n_steps = max(len(fill[0]), len(fill[1]))

        # 2) liveness: last step at which each value is read
        for i, op in enumerate(ops):
            if not is_alu[i]:
                continue
            for src in (op.a, op.b):
                ops[src].last_use_step = max(ops[src].last_use_step, op.step)
        for idx in self.outputs:
            ops[idx].last_use_step = n_steps + 1  # live to the end

        # 3) linear-scan register allocation
        #    reg 0 = always-zero scratch source for idle lanes
        next_reg = 1
        free: List[int] = []
        # inputs and constants are defined "before step 0"
        expiry: Dict[int, List[int]] = {}  # step -> regs to free after it

        def alloc(op: _Op, def_step: int):
            nonlocal next_reg
            if free:
                op.reg = free.pop()
            else:
                op.reg = next_reg
                next_reg += 1
            if op.last_use_step >= 0:
                expiry.setdefault(op.last_use_step, []).append(op.reg)
            else:
                # value never used (dead code): free right away
                expiry.setdefault(def_step, []).append(op.reg)

        for i, op in enumerate(ops):
            if op.kind in (-1, -2):
                alloc(op, -1)
        # walk steps in order, allocating defs and freeing after last use
        by_step: Dict[int, List[int]] = {}
        for i, op in enumerate(ops):
            if is_alu[i]:
                by_step.setdefault(op.step, []).append(i)
        for t in range(n_steps):
            for i in by_step.get(t, ()):
                alloc(ops[i], t)
            for r in expiry.get(t, ()):
                free.append(r)

        sched_steps = n_steps  # pre-padding schedule length
        n_steps = -(-n_steps // pad_steps_to) * pad_steps_to
        n_regs = next_reg
        # trash registers for idle lanes
        trash_mul = n_regs
        trash_lin = n_regs + w_mul
        n_regs += w_mul + w_lin
        if n_regs < pad_regs_to:
            n_regs = pad_regs_to

        # 4) instruction arrays
        msa = np.zeros((n_steps, w_mul), dtype=np.int32)
        msb = np.zeros((n_steps, w_mul), dtype=np.int32)
        msd = np.full((n_steps, w_mul), -1, dtype=np.int32)
        lsa = np.zeros((n_steps, w_lin), dtype=np.int32)
        lsb = np.zeros((n_steps, w_lin), dtype=np.int32)
        lsub = np.zeros((n_steps, w_lin), dtype=bool)
        lsd = np.full((n_steps, w_lin), -1, dtype=np.int32)
        lane_ptr = [[0] * n_steps, [0] * n_steps]
        for i, op in enumerate(ops):
            if not is_alu[i]:
                continue
            t, u = op.step, unit_of[i]
            lane = lane_ptr[u][t]
            lane_ptr[u][t] = lane + 1
            ra, rb = ops[op.a].reg, ops[op.b].reg
            if u == 0:
                msa[t, lane], msb[t, lane], msd[t, lane] = ra, rb, op.reg
            else:
                lsa[t, lane], lsb[t, lane], lsd[t, lane] = ra, rb, op.reg
                lsub[t, lane] = op.kind == _SUB
        # idle lanes -> trash registers (zero sources)
        for t in range(n_steps):
            for lane in range(lane_ptr[0][t], w_mul):
                msd[t, lane] = trash_mul + lane
            for lane in range(lane_ptr[1][t], w_lin):
                lsd[t, lane] = trash_lin + lane

        const_payload = {
            op.reg: op.a for op in ops if op.kind == -2
        }
        input_regs = [ops[i].reg for i in self.inputs]
        output_regs = [ops[i].reg for i in self.outputs]

        n_mul = sum(1 for i, op in enumerate(ops) if is_alu[i] and unit_of[i] == 0)
        n_lin = sum(1 for i, op in enumerate(ops) if is_alu[i] and unit_of[i] == 1)
        return Program(
            n_regs=n_regs,
            instr=(msa, msb, msd, lsa, lsb, lsub, lsd),
            input_regs=np.asarray(input_regs, dtype=np.int32),
            input_names=list(self.input_names),
            output_regs=np.asarray(output_regs, dtype=np.int32),
            output_names=list(self.output_names),
            const_regs=const_payload,
            n_steps=n_steps,
            meta={
                "sched_steps": sched_steps,
                "n_mul": n_mul,
                "n_lin": n_lin,
                "alloc_regs": next_reg,
                "trash_mul": trash_mul,
                "trash_lin": trash_lin,
                "w_mul": w_mul,
                "w_lin": w_lin,
            },
        )


@dataclass
class Program:
    """Assembled VM program: static instruction tensors + register map."""

    n_regs: int
    instr: Tuple[np.ndarray, ...]  # (msa, msb, msd, lsa, lsb, lsub, lsd)
    input_regs: np.ndarray
    input_names: List[str]
    output_regs: np.ndarray
    output_names: List[str]
    const_regs: Dict[int, int]  # reg -> plain int value
    n_steps: int
    meta: Optional[Dict] = None  # assemble-time schedule stats

    @classmethod
    def from_arrays(cls, n_regs, instr, input_regs, input_names, output_regs,
                    output_names, const_regs, n_steps) -> "Program":
        """A Program from plain fields — e.g. those of a program assembled
        by another implementation of the same VM (duck-typed: numpy arrays,
        lists and ints only)."""
        msa, msb, msd, lsa, lsb, lsub, lsd = (np.asarray(x) for x in instr)
        i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)
        return cls(
            n_regs=int(n_regs),
            instr=(i32(msa), i32(msb), i32(msd), i32(lsa), i32(lsb),
                   np.ascontiguousarray(lsub, dtype=bool), i32(lsd)),
            input_regs=i32(input_regs),
            input_names=list(input_names),
            output_regs=i32(output_regs),
            output_names=list(output_names),
            const_regs={int(r): int(v) for r, v in dict(const_regs).items()},
            n_steps=int(n_steps),
        )

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_device_instr", None)  # device tensors are not pickled
        return state

    def const_template(self) -> np.ndarray:
        """(n_regs, L) uint64 register template with constants loaded."""
        t = np.zeros((self.n_regs, fq.NUM_LIMBS), dtype=np.uint64)
        for reg, value in self.const_regs.items():
            t[reg] = fq.to_mont_int(value)
        return t

    def stack_inputs(self, values: Dict[str, np.ndarray],
                     batch_shape) -> np.ndarray:
        """Stack named inputs into (batch..., n_inputs, L) uint64 in
        input_names order. Program inputs are canonical Montgomery
        residues: a limb >= 2^28 is refused."""
        n_in = len(self.input_names)
        out = np.zeros(tuple(batch_shape) + (n_in, fq.NUM_LIMBS),
                       dtype=np.uint64)
        for idx, name in enumerate(self.input_names):
            v = np.asarray(values[name], dtype=np.uint64)
            if v.size and int(v.max()) >> fq.LIMB_BITS:
                raise ValueError(
                    f"input {name!r} has limbs >= 2^{fq.LIMB_BITS} — program "
                    "inputs must be canonical Montgomery residues"
                )
            out[..., idx, :] = v
        return out

    def device_instr(self, device) -> Tuple[torch.Tensor, ...]:
        """The instruction tensors on ``device`` (int32; lsub as uint8),
        uploaded once per device and kept on the program. Register indices
        are checked against the register file here, once, because the
        kernel does not check them."""
        cache = self.__dict__.setdefault("_device_instr", {})
        device = torch.device(device)
        key = str(device)
        if key not in cache:
            msa, msb, msd, lsa, lsb, lsub, lsd = self.instr
            for x in (msa, msb, msd, lsa, lsb, lsd):
                if x.size and (int(x.min()) < 0 or int(x.max()) >= self.n_regs):
                    raise ValueError("register index out of range")
            t = lambda x, dt: torch.from_numpy(
                np.ascontiguousarray(x, dtype=dt)).to(device)
            uploaded = (t(msa, np.int32), t(msb, np.int32),
                        t(msd, np.int32), t(lsa, np.int32),
                        t(lsb, np.int32), t(lsub, np.uint8),
                        t(lsd, np.int32))
            if device.type == "cuda":
                # other streams (a mesh's slots, the service's stages)
                # read them next: let the upload land first
                torch.cuda.current_stream(device).synchronize()
            cache[key] = uploaded
        return cache[key]


def _lin_plain(la: torch.Tensor, lb: torch.Tensor,
               lsub: torch.Tensor) -> torch.Tensor:
    """LIN unit, plain version: a + (sub ? (MP+1) + (MASK - b) : b),
    carried, the 2^420 overflow limb dropped."""
    # MP + 1: the additive shift of the borrowless subtract
    comp = fq._const("mp_plus_1", la.device) + (fq.MASK - lb)
    rhs = torch.where(lsub.bool()[..., None], comp, lb)
    return fq._carry_limbs(la + rhs)


def _vm_step_plain(regs: torch.Tensor, instr) -> torch.Tensor:
    """One VM step, plain PyTorch version of the step kernel: gather every
    operand, then scatter the MUL results, then the LIN results. Updates
    ``regs`` (..., n_regs, 15) in place and returns it."""
    msa, msb, msd, lsa, lsb, lsub, lsd = instr
    m = fq.mont_mul_plain(regs[..., msa, :], regs[..., msb, :])
    lin = _lin_plain(regs[..., lsa, :], regs[..., lsb, :], lsub)
    regs[..., msd, :] = m
    regs[..., lsd, :] = lin
    return regs


def _run_steps_plain(regs: torch.Tensor, instr) -> torch.Tensor:
    """Every step of an instruction stream through ``_vm_step_plain``."""
    for s in range(instr[0].shape[0]):
        _vm_step_plain(regs, tuple(x[s] for x in instr))
    return regs


def _init_regs(program: Program, stacked: np.ndarray,
               device) -> torch.Tensor:
    """(rows, n_regs, 15) int64 register file: the const template
    broadcast over the rows, the stacked inputs scattered in."""
    rows = stacked.shape[0]
    template = fq.limbs_from_numpy(program.const_template(), device)
    regs = template.expand((rows,) + tuple(template.shape)).contiguous()
    regs[:, torch.as_tensor(program.input_regs.astype(np.int64),
                            device=device), :] = fq.limbs_from_numpy(
        stacked, device)
    return regs


def execute(program: Program, inputs: Dict[str, np.ndarray], batch_shape=(),
            device=None, mesh=None) -> Dict[str, np.ndarray]:
    """Run an assembled program. Input arrays are canonical Montgomery
    limb arrays of shape batch_shape + (15,). Returns the named outputs as
    uint64 arrays (loose, bounded < 2^382), like the JAX package's
    ``vm.execute`` in its default mode.

    ``device=None`` runs on the CUDA card (every step through the fused
    step kernel); ``device="cpu"`` runs the plain PyTorch steps.

    ``mesh`` (a ``utils/torch_env.Mesh``) shards the leading row axis
    over all of its slots: ``batch_shape[0]`` must divide by the slot
    count, or the call raises. Slot i takes the i-th contiguous block of
    rows, staged on its device and run on its stream (one kernel launch
    a slot on the card); the instruction stream is replicated and the
    step needs no exchange between slots. Every slot's stream is
    synchronized before the timer stops, and the outputs are gathered
    in slot order. A ``device`` that is not one of the mesh's raises.

    Route (CONSENSUS_SPECS_TPU_VM_EXEC, ops/vm_compile.py): ``interp``
    runs the steps; ``fused`` the straight-line lowering (the same
    schedule, limb-identical outputs; on the card its Montgomery products
    are launches of the Montgomery kernel in CUDA graphs); ``auto``
    (default) takes fused only where its units are built for this call's
    rows and streams and its measured ms/row beats the interpreter's. A
    failure in the fused route falls back to the interpreter with a
    ``vm/fused_fallback`` flight event.

    Each call is timed under ``vm[steps=...,regs=...,batch=...,sharded=
    ...]`` in ``ops/profiling``, noted on its device's lane (each slot's
    lane under a mesh) of the occupancy ledger (``obs/devices.py``), in
    the route's ms/row ledger and, with tracing on, in the tracer
    (``obs/tracing.py``). The card is synchronized before the interval
    ends, so it covers the card's work."""
    from ..obs import devices, tracing
    from ..utils import torch_env
    from . import profiling, vm_compile

    dev = torch_env.resolve(device, mesh)
    batch_shape = tuple(int(d) for d in batch_shape)
    rows = int(np.prod(batch_shape)) if batch_shape else 1
    sharded = mesh is not None
    if sharded and (not batch_shape or batch_shape[0] % mesh.size):
        raise ValueError(f"batch {batch_shape} does not shard over "
                         f"{mesh.size} slots")
    label = (f"vm[steps={program.n_steps},regs={program.n_regs},"
             f"batch={batch_shape},sharded={sharded}]")
    path = "interp"
    compile_inclusive = False
    t0 = time.perf_counter()
    with profiling.timed(label):
        stacked = program.stack_inputs(inputs, batch_shape).reshape(
            (rows, len(program.input_names), fq.NUM_LIMBS))
        sig = (vm_compile.mesh_shape_sig(rows, mesh) if sharded
               else vm_compile.shape_sig(batch_shape, dev))
        out = None
        if vm_compile.use_fused(program, shape_sig=sig):
            try:
                out, compile_inclusive = vm_compile.run_fused(
                    program, stacked, dev, mesh=mesh)
                path = "fused"
            except Exception as e:
                vm_compile.note_fallback(program, e)
                out = None
        if out is None and sharded:
            out = _execute_mesh(program, stacked, mesh)
        elif out is None:
            regs = _init_regs(program, stacked, dev)
            cuda_step.run_steps(regs, program.device_instr(dev))
            out_idx = torch.as_tensor(program.output_regs.astype(np.int64),
                                      device=dev)
            out = regs[:, out_idx, :]
            # the route ledger below compares the two routes' times, so
            # the interpreter's stops once the card has run it too (the
            # fused route synchronized inside its fallback net)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        out = out.cpu().numpy().astype(np.uint64)
    dt = time.perf_counter() - t0
    vm_compile.note_execution(program, path, dt, rows, compile_inclusive)
    if tracing.trace_enabled():
        tracing.global_tracer().note_execution(
            steps=program.n_steps, regs=program.n_regs, batch=batch_shape,
            sharded=sharded, t0=t0, seconds=dt)
    ledger = devices.maybe_ledger()
    if ledger is not None:
        ledger.note_execution(dev, t0, dt,
                              label=f"vm[steps={program.n_steps}]",
                              mesh=mesh)
    out = out.reshape(batch_shape + out.shape[1:])
    return {
        name: out[..., i, :] for i, name in enumerate(program.output_names)
    }


def _execute_mesh(program: Program, stacked: np.ndarray,
                  mesh) -> torch.Tensor:
    """The interpreter over a mesh: slot i's contiguous block of rows
    staged on its device and run on its stream (every slot's launch is
    issued before any slot is waited on), then every slot's stream
    synchronized and the outputs gathered in slot order on the CPU."""
    block = stacked.shape[0] // mesh.size
    out_idx = program.output_regs.astype(np.int64)
    outs = []
    for slot in mesh.slots:
        with slot.context():
            regs = _init_regs(
                program, stacked[slot.index * block:(slot.index + 1) * block],
                slot.device)
            cuda_step.run_steps(regs, program.device_instr(slot.device))
            outs.append(regs[:, torch.as_tensor(out_idx,
                                                device=slot.device), :])
    gathered = []
    for slot, o in zip(mesh.slots, outs):
        with slot.context():
            slot.synchronize()
            gathered.append(o.cpu())
    return torch.cat(gathered)
