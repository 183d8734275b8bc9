"""BLS12-381 pairing pipeline expressed as field-ALU VM programs.

The port's copy of consensus_specs_tpu/ops/vmlib.py: the same builders,
assembled by the port's own ``vm.Prog``, so that both packages emit the
same instruction tensors (tests/test_torch_vm.py holds them identical).

Builds the straight-line programs the VM (ops.vm) schedules onto the device:

- PROG A `miller_product(K)`: tree-reduce K projective G1 pubkey points
  (Renes-Costello-Batina complete additions — branchless, infinity-safe, so
  masked committee lanes are just infinity inputs), then run both Miller
  loops of the verification equation
      e(agg_pk, H(m)) * e(-g1, sig)
  with the aggregate consumed PROJECTIVELY (line functions scaled by the
  subfield factors Z_P/X_P/Y_P, which the final exponentiation kills — no
  inversion anywhere on device). Outputs the paired f in Fq12 and the
  aggregate's Z (host checks infinity).

- PROG B `hard_part`: the Hayashida-Hayasaka-Teruya hard part of the final
  exponentiation on a unitary g, using Granger-Scott cyclotomic squarings:
      3*(p^4-p^2+1)/r = (x-1)^2 * (x+p) * (x^2+p^2-1) + 3
  (exact-integer identity asserted below; the factor 3 is sound because f^E
  lies in the order-r subgroup and gcd(3, r) = 1).

The easy part (one Fq12 inversion + two Frobenius/multiplies) runs on HOST
with exact integers between the two programs — inversion is the only
data-dependent-depth operation and is a few microseconds in Python, while
on device it would serialize ~570 scan steps.

Ate-loop and exponent bit patterns are STATIC, so conditional Miller adds
exist only at the 6 set bits of the BLS parameter — no runtime selects.

All formulas are cross-checked against the pure-Python oracle
(tests/test_vm.py, on the JAX package's copy); the reference's equivalent backend is the milagro C
binding (reference utils/bls.py:17-22).
"""
from typing import List, Sequence, Tuple

from ..utils.bls12_381 import (
    ISO_X_DEN,
    ISO_X_NUM,
    ISO_Y_DEN,
    ISO_Y_NUM,
    P,
    X_PARAM,
    _PSI_CX,
    _PSI_CY,
)
from .vm import Prog, Val

# BLS parameter bit patterns (static schedules)
ATE_BITS = [int(b) for b in bin(-X_PARAM)[2:]]  # MSB-first
ABS_X_BITS = ATE_BITS
ABS_X_PLUS_1_BITS = [int(b) for b in bin(-X_PARAM + 1)[2:]]

# HHT hard-part identity (exact check at import)
_R_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
assert 3 * ((P**4 - P**2 + 1) // _R_ORDER) == (X_PARAM - 1) ** 2 * (
    X_PARAM + P
) * (X_PARAM**2 + P**2 - 1) + 3

# Frobenius gamma constants: frob^n(w^k) = xi^(k*(p^n-1)/6) * w^k, xi = 1+u
def _fq2_mul_int(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def _fq2_pow_int(base, e: int):
    acc = (1, 0)
    while e:
        if e & 1:
            acc = _fq2_mul_int(acc, base)
        base = _fq2_mul_int(base, base)
        e >>= 1
    return acc


GAMMA = {
    n: [_fq2_pow_int((1, 1), k * (P**n - 1) // 6) for k in range(6)]
    for n in (1, 2, 3)
}


class F2:
    """Fq2 element of two symbolic Vals (c0 + c1*u, u^2 = -1)."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Val, c1: Val):
        self.c0 = c0
        self.c1 = c1

    @property
    def prog(self) -> Prog:
        return self.c0.prog

    def __add__(self, o: "F2") -> "F2":
        return F2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "F2") -> "F2":
        return F2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "F2") -> "F2":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return F2(t0 - t1, t2 - (t0 + t1))

    def square(self) -> "F2":
        c0 = (self.c0 + self.c1) * (self.c0 - self.c1)
        m = self.c0 * self.c1
        return F2(c0, m + m)

    def double(self) -> "F2":
        return F2(self.c0 + self.c0, self.c1 + self.c1)

    def neg(self) -> "F2":
        z = self.prog.const(0)
        return F2(z - self.c0, z - self.c1)

    def conj(self) -> "F2":
        z = self.prog.const(0)
        return F2(self.c0, z - self.c1)

    def mul_xi(self) -> "F2":
        """* (1 + u)."""
        return F2(self.c0 - self.c1, self.c0 + self.c1)

    def scale(self, s: Val) -> "F2":
        return F2(self.c0 * s, self.c1 * s)

    def mul_const(self, c: Tuple[int, int]) -> "F2":
        p = self.prog
        if c == (1, 0):
            return self
        if c[1] == 0:
            k = p.const(c[0])
            return F2(self.c0 * k, self.c1 * k)
        if c[0] == 0:
            k = p.const(c[1])
            # (c0 + c1 u) * k u = -c1 k + c0 k u
            z = p.const(0)
            return F2(z - (self.c1 * k), self.c0 * k)
        return self * F2(p.const(c[0]), p.const(c[1]))


def f2_inputs(prog: Prog, name: str) -> F2:
    return F2(prog.inp(name + ".0"), prog.inp(name + ".1"))


def f2_const(prog: Prog, c0: int, c1: int) -> F2:
    return F2(prog.const(c0), prog.const(c1))


# ---------------------------------------------------------------------------
# Fq12 flat basis (12 Vals, w-powers; w^12 - 2 w^6 + 2 = 0, w^6 = 1 + u)
# ---------------------------------------------------------------------------

def _reduce_cols(prog: Prog, cols: List[Val]) -> List[Val]:
    """Fold degrees 22..12 down with w^12 = 2w^6 - 2."""
    for k in range(22, 11, -1):
        c = cols[k]
        if c is None:
            continue
        c2 = c + c
        cols[k - 6] = c2 if cols[k - 6] is None else cols[k - 6] + c2
        cols[k - 12] = (
            prog.const(0) - c2 if cols[k - 12] is None else cols[k - 12] - c2
        )
    return cols[:12]


def _recombine(p0: List[Val], mid: List[Val], p2: List[Val],
               h: int, n: int) -> List[Val]:
    """Karatsuba recombination: p0 at 0, mid at h, p2 at 2h (overlaps add).
    Entries may be None (sparse columns)."""
    out: List[Val] = [None] * (2 * n - 1)
    for i, v in enumerate(p0):
        if v is not None:
            out[i] = v
    for i, v in enumerate(mid):
        if v is not None:
            out[h + i] = v if out[h + i] is None else out[h + i] + v
    for i, v in enumerate(p2):
        if v is not None:
            k = 2 * h + i
            out[k] = v if out[k] is None else out[k] + v
    return out


def _poly_mul(prog: Prog, a: List[Val], b: List[Val]) -> List[Val]:
    """Product of coefficient lists via recursive Karatsuba (12 -> 6 -> 3
    splits: 54 Fq muls instead of 144 schoolbook — the mul unit is the
    VM's scarce resource; the extra adds ride the wider LIN unit)."""
    n = len(a)
    assert len(b) == n
    if n <= 2:
        if n == 1:
            return [a[0] * b[0]]
        p0 = a[0] * b[0]
        p1 = a[1] * b[1]
        mid = (a[0] + a[1]) * (b[0] + b[1]) - (p0 + p1)
        return [p0, mid, p1]
    if n == 3:
        # 3-term Karatsuba: 6 muls
        p0 = a[0] * b[0]
        p1 = a[1] * b[1]
        p2 = a[2] * b[2]
        m01 = (a[0] + a[1]) * (b[0] + b[1]) - (p0 + p1)
        m02 = (a[0] + a[2]) * (b[0] + b[2]) - (p0 + p2)
        m12 = (a[1] + a[2]) * (b[1] + b[2]) - (p1 + p2)
        return [p0, m01, m02 + p1, m12, p2]
    h = n // 2
    assert n % 2 == 0
    a0, a1 = a[:h], a[h:]
    b0, b1 = b[:h], b[h:]
    p0 = _poly_mul(prog, a0, b0)
    p2 = _poly_mul(prog, a1, b1)
    asum = [x + y for x, y in zip(a0, a1)]
    bsum = [x + y for x, y in zip(b0, b1)]
    pm = _poly_mul(prog, asum, bsum)
    mid = [m - (x + y) for m, x, y in zip(pm, p0, p2)]
    return _recombine(p0, mid, p2, h, n)


def _poly_square(prog: Prog, a: List[Val]) -> List[Val]:
    """Square of a coefficient list: Karatsuba splits down to 3-term
    symmetric schoolbook (54 Fq muls for 12 terms instead of 78)."""
    n = len(a)
    if n <= 3:
        cols: List[Val] = [None] * (2 * n - 1)
        for i in range(n):
            for j in range(i, n):
                p = a[i] * a[j]
                if i != j:
                    p = p + p
                k = i + j
                cols[k] = p if cols[k] is None else cols[k] + p
        return cols
    h = n // 2
    assert n % 2 == 0
    a0, a1 = a[:h], a[h:]
    p0 = _poly_square(prog, a0)
    p2 = _poly_square(prog, a1)
    pm = _poly_square(prog, [x + y for x, y in zip(a0, a1)])
    mid = [m - (x + y) for m, x, y in zip(pm, p0, p2)]
    return _recombine(p0, mid, p2, h, n)


def f12_mul(prog: Prog, a: List[Val], b: List[Val]) -> List[Val]:
    return _reduce_cols(prog, _poly_mul(prog, a, b))


def f12_square(prog: Prog, a: List[Val]) -> List[Val]:
    return _reduce_cols(prog, _poly_square(prog, a))


def f12_conj(prog: Prog, a: List[Val]) -> List[Val]:
    """x -> x^(p^6): negate odd w-powers."""
    z = prog.const(0)
    return [a[k] if k % 2 == 0 else z - a[k] for k in range(12)]


def f12_one(prog: Prog) -> List[Val]:
    one = prog.const(1)
    z = prog.const(0)
    return [one] + [z] * 11


# component view: c_k (Fq2) at w^k for k = 0..5;
# flat[k] = a_k - b_k, flat[k+6] = b_k  (since u = w^6 - 1)


def f12_to_comps(a: List[Val]) -> List[F2]:
    return [F2(a[k] + a[k + 6], a[k + 6]) for k in range(6)]


def f12_from_comps(comps: Sequence[F2]) -> List[Val]:
    return [comps[k].c0 - comps[k].c1 for k in range(6)] + [
        comps[k].c1 for k in range(6)
    ]


def f12_frobenius(prog: Prog, a: List[Val], n: int) -> List[Val]:
    comps = f12_to_comps(a)
    out = []
    for k in range(6):
        c = comps[k]
        if n % 2 == 1:
            c = c.conj()
        out.append(c.mul_const(GAMMA[n][k]))
    return f12_from_comps(out)


def f12_cyclotomic_square(prog: Prog, a: List[Val]) -> List[Val]:
    """Granger-Scott squaring for unitary elements of the cyclotomic
    subgroup (9 Fq2 squarings). Component slots (tower naming):
    C0.B0=w^0, C0.B1=w^2, C0.B2=w^4, C1.B0=w^1, C1.B1=w^3, C1.B2=w^5."""
    c = f12_to_comps(a)
    c0b0, c1b0, c0b1, c1b1, c0b2, c1b2 = c[0], c[1], c[2], c[3], c[4], c[5]

    t0 = c1b1.square()
    t1 = c0b0.square()
    t6 = (c1b1 + c0b0).square() - t0 - t1  # 2*c0b0*c1b1
    t2 = c0b2.square()
    t3 = c1b0.square()
    t7 = (c0b2 + c1b0).square() - t2 - t3  # 2*c0b2*c1b0
    t4 = c1b2.square()
    t5 = c0b1.square()
    t8 = ((c1b2 + c0b1).square() - t4 - t5).mul_xi()  # 2*xi*c0b1*c1b2

    t0 = t0.mul_xi() + t1  # c0b0^2 + xi*c1b1^2
    t2 = t2.mul_xi() + t3  # c1b0^2 + xi*c0b2^2
    t4 = t4.mul_xi() + t5  # c0b1^2 + xi*c1b2^2

    z0 = (t0 - c0b0).double() + t0
    z1 = (t2 - c0b1).double() + t2
    z2 = (t4 - c0b2).double() + t4
    z3 = (t8 + c1b0).double() + t8
    z4 = (t6 + c1b1).double() + t6
    z5 = (t7 + c1b2).double() + t7
    return f12_from_comps([z0, z3, z1, z4, z2, z5])


def f12_unitary_pow_abs(prog: Prog, g: List[Val], bits: Sequence[int]) -> List[Val]:
    """g^e for a STATIC msb-first bit string, cyclotomic squarings + dense
    multiplies at set bits. g must be unitary."""
    acc = g
    for bit in bits[1:]:
        acc = f12_cyclotomic_square(prog, acc)
        if bit:
            acc = f12_mul(prog, acc, g)
    return acc


def f12_pow_x(prog: Prog, g: List[Val]) -> List[Val]:
    """g^x, x the (negative) BLS parameter; unitary g."""
    return f12_conj(prog, f12_unitary_pow_abs(prog, g, ABS_X_BITS))


def f12_pow_x_minus_1(prog: Prog, g: List[Val]) -> List[Val]:
    """g^(x-1) = conj(g^(|x|+1)); unitary g."""
    return f12_conj(prog, f12_unitary_pow_abs(prog, g, ABS_X_PLUS_1_BITS))


# ---------------------------------------------------------------------------
# G1: Renes-Costello-Batina complete addition (projective, a=0, b=4, b3=12)
# ---------------------------------------------------------------------------


def g1_complete_add(prog: Prog, p1, p2):
    """(X3:Y3:Z3) = P1 + P2, complete (handles doubling and infinity).
    RCB 2016 algorithm 7 for y^2 = x^3 + 4; b3 = 12."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    b3 = prog.const(12)

    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)  # X1Y2 + X2Y1
    t4 = (Y1 + Z1) * (Y2 + Z2)
    t4 = t4 - (t1 + t2)  # Y1Z2 + Y2Z1
    X3 = (X1 + Z1) * (X2 + Z2)
    Y3 = X3 - (t0 + t2)  # X1Z2 + X2Z1
    X3 = t0 + t0
    t0 = X3 + t0  # 3 X1X2
    t2 = b3 * t2
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = b3 * Y3
    X3 = t4 * Y3
    t2 = t3 * t1
    X3 = t2 - X3
    Y3 = Y3 * t0
    t1 = t1 * Z3
    Y3 = t1 + Y3
    t0 = t0 * t3
    Z3 = Z3 * t4
    Z3 = Z3 + t0
    return (X3, Y3, Z3)


def g1_tree_sum(prog: Prog, points):
    """Pairwise tree reduction of projective points (log2 depth)."""
    while len(points) > 1:
        nxt = []
        for i in range(0, len(points) - 1, 2):
            nxt.append(g1_complete_add(prog, points[i], points[i + 1]))
        if len(points) % 2:
            nxt.append(points[-1])
        points = nxt
    return points[0]


# ---------------------------------------------------------------------------
# Miller loop (T Jacobian on the twist; P projective G1)
# ---------------------------------------------------------------------------


def _line_to_flat(c_1: F2, c_vw: F2, c_v2w: F2) -> dict:
    """Sparse line: tower slots 1 (w^0), v*w (w^3), v^2*w (w^5)."""
    return {0: c_1, 3: c_vw, 5: c_v2w}


def _mul6_sparse035(cols_len: int, f6: List[Val], s: dict) -> List[Val]:
    """6-term dense x sparse {w^0, w^3, w^5} product columns (18 muls)."""
    cols: List[Val] = [None] * cols_len
    for j, lj in s.items():
        for i in range(6):
            p = f6[i] * lj
            k = i + j
            cols[k] = p if cols[k] is None else cols[k] + p
    return cols


def f12_mul_sparse(prog: Prog, a: List[Val], line: dict) -> List[Val]:
    """a * line where line has Fq2 components at w-powers {0, 3, 5}:
    flat coeffs at k: c0-c1, at k+6: c1 — 6 nonzero flat coeffs. One
    Karatsuba split (a = F0 + F1 w^6; line = A + B w^6, A and B both
    {0,3,5}-sparse) does it in 3 x 18 = 54 muls instead of 72."""
    A = {k: f2.c0 - f2.c1 for k, f2 in line.items()}
    B = {k: f2.c1 for k, f2 in line.items()}
    F0, F1 = a[:6], a[6:]
    p0 = _mul6_sparse035(11, F0, A)
    p2 = _mul6_sparse035(11, F1, B)
    ab = {k: A[k] + B[k] for k in A}
    pm = _mul6_sparse035(11, [x + y for x, y in zip(F0, F1)], ab)
    mid = [
        None if m is None else m - (x + y)
        for m, x, y in zip(pm, p0, p2)
    ]
    cols = _recombine(p0, mid, p2, 6, 12)
    z = None
    for k in range(12):
        if cols[k] is None:
            z = z or prog.const(0)
            cols[k] = z
    return _reduce_cols(prog, cols)


def _dbl_step(prog: Prog, T, Pxyz):
    """Double T, return (line, 2T); line scaled by the projective P factors."""
    X, Y, Z = T
    XP, YP, ZP = Pxyz
    X2 = X.square()
    A3 = X2 + X2 + X2  # 3X^2
    Y2 = Y.square()
    Z2 = Z.square()
    YZ = Y * Z
    YZ3 = YZ * Z2  # Y*Z^3
    two_YZ3 = YZ3 + YZ3

    c_1 = two_YZ3.mul_xi().neg().scale(YP)
    c_v2w = (A3 * Z2).scale(XP)
    c_vw = (Y2 + Y2 - A3 * X).scale(ZP)
    line = _line_to_flat(c_1, c_vw, c_v2w)

    # Jacobian doubling (a = 0), sharing X2/Y2/YZ
    C = Y2.square()
    t = (X + Y2).square() - X2 - C
    D = t + t
    F = A3.square()
    X3 = F - (D + D)
    C8 = C.double().double().double()
    Y3 = A3 * (D - X3) - C8
    Z3n = YZ + YZ
    return line, (X3, Y3, Z3n)


def _add_step(prog: Prog, T, Q, Pxyz):
    """T + Q (Q affine), with the line through them, scaled by projective P."""
    X, Y, Z = T
    qx, qy = Q
    XP, YP, ZP = Pxyz
    Z2 = Z.square()
    Z3 = Z2 * Z
    U2 = qx * Z2
    S2 = qy * Z3
    H = U2 - X
    Rr = S2 - Y
    HZ = H * Z

    c_1 = HZ.mul_xi().neg().scale(YP)
    c_v2w = Rr.scale(XP)
    c_vw = (qy * HZ - Rr * qx).scale(ZP)
    line = _line_to_flat(c_1, c_vw, c_v2w)

    H2 = H.square()
    H3 = H2 * H
    V = X * H2
    R2 = Rr.square()
    X3 = R2 - H3 - (V + V)
    Y3 = Rr * (V - X3) - Y * H3
    return line, (X3, Y3, HZ)


def miller_loop(prog: Prog, Q, Pxyz) -> List[Val]:
    """f_{|x|}(Q, P) with the negative-x conjugation. Q = (qx, qy) affine F2
    pairs on the twist; Pxyz = projective G1 Vals. Static ate bit schedule —
    add-steps only at set bits."""
    qx, qy = Q
    one = f2_const(prog, 1, 0)
    T = (qx, qy, one)
    f = None  # lazily 1; first square is a no-op

    for bit in ATE_BITS[1:]:
        if f is not None:
            f = f12_square(prog, f)
        line, T = _dbl_step(prog, T, Pxyz)
        if f is None:
            f = f12_from_comps(
                [line.get(k, f2_const(prog, 0, 0)) for k in range(6)]
            )
        else:
            f = f12_mul_sparse(prog, f, line)
        if bit:
            line, T = _add_step(prog, T, Q, Pxyz)
            f = f12_mul_sparse(prog, f, line)
    return f12_conj(prog, f)


# ---------------------------------------------------------------------------
# program builders
# ---------------------------------------------------------------------------

# affine -(G1 generator)
_G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
_G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1


def _emit_miller_product(prog: Prog, ns: str, k_pubkeys: int) -> None:
    """One verification circuit (aggregate + both Miller loops) under name
    prefix ``ns``; see build_miller_product."""
    pts = [
        (
            prog.inp(f"{ns}pk{j}.x"),
            prog.inp(f"{ns}pk{j}.y"),
            prog.inp(f"{ns}pk{j}.z"),
        )
        for j in range(k_pubkeys)
    ]
    hx = f2_inputs(prog, f"{ns}h.x")
    hy = f2_inputs(prog, f"{ns}h.y")
    sx = f2_inputs(prog, f"{ns}sig.x")
    sy = f2_inputs(prog, f"{ns}sig.y")

    agg = g1_tree_sum(prog, pts) if k_pubkeys > 1 else pts[0]

    f1 = miller_loop(prog, (hx, hy), agg)
    ng = (prog.const(_G1_X), prog.const((-_G1_Y) % P), prog.const(1))
    f2_ = miller_loop(prog, (sx, sy), ng)
    f = f12_mul(prog, f1, f2_)
    for i in range(12):
        prog.out(f[i], f"{ns}f.{i}")
    prog.out(agg[2], f"{ns}aggz")


def build_miller_product(k_pubkeys: int, fold: int = 1) -> Prog:
    """PROG A: aggregate K projective pubkeys + both Miller loops.

    Inputs: pk{j}.{x,y,z} (projective G1; infinity = (0,1,0) for masked
    lanes), h.{x,y}.{0,1} (H(m) on the twist, affine Fq2), sig.{x,y}.{0,1}.
    Outputs: f.0..f.11 (Fq12, pre-final-exp), aggz (aggregate Z).

    ``fold`` > 1 LANE-FOLDS that many independent verification items into
    ONE program (names prefixed ``i{t}.``): a single item's instruction-
    level parallelism saturates only ~1/3 of the mul lanes (the schedule is
    depth-bound), so folding F items multiplies per-step ILP by F and cuts
    per-item step count almost F-fold until the work bound is reached."""
    prog = Prog()
    if fold == 1:
        _emit_miller_product(prog, "", k_pubkeys)
    else:
        for t in range(fold):
            _emit_miller_product(prog, f"i{t}.", k_pubkeys)
    return prog


def _emit_aggregate_verify_miller(prog: Prog, ns: str, k_pairs: int) -> None:
    one = prog.const(1)
    f = None
    for j in range(k_pairs):
        pxyz = (
            prog.inp(f"{ns}pk{j}.x"),
            prog.inp(f"{ns}pk{j}.y"),
            prog.inp(f"{ns}pk{j}.z"),
        )
        hx = f2_inputs(prog, f"{ns}h{j}.x")
        hy = f2_inputs(prog, f"{ns}h{j}.y")
        fj = miller_loop(prog, (hx, hy), pxyz)
        f = fj if f is None else f12_mul(prog, f, fj)
    sx = f2_inputs(prog, f"{ns}sig.x")
    sy = f2_inputs(prog, f"{ns}sig.y")
    ng = (prog.const(_G1_X), prog.const((-_G1_Y) % P), one)
    f2_ = miller_loop(prog, (sx, sy), ng)
    f = f12_mul(prog, f, f2_)
    for i in range(12):
        prog.out(f[i], f"{ns}f.{i}")


def build_aggregate_verify_miller(k_pairs: int, fold: int = 1) -> Prog:
    """PROG A variant for AggregateVerify: prod_i e(pk_i, H(m_i)) * e(-g1, sig).
    Pubkeys PROJECTIVE so inactive lanes can pass infinity (0:1:0), whose
    Miller factor lands in a proper subfield and is killed by the final
    exponentiation. ``fold`` as in build_miller_product."""
    prog = Prog()
    if fold == 1:
        _emit_aggregate_verify_miller(prog, "", k_pairs)
    else:
        for t in range(fold):
            _emit_aggregate_verify_miller(prog, f"i{t}.", k_pairs)
    return prog


# ---------------------------------------------------------------------------
# codec-plane programs (ops/codec.py): projective complete arithmetic on the
# G2 curve (RCB over Fq2), psi endomorphism, subgroup checks, and the
# hash-to-G2 finish (isogeny + cofactor clearing)
# ---------------------------------------------------------------------------


def _f2_mul_b3(v: F2) -> F2:
    """v * b3 on the G2 curve: b = 4(1+u), b3 = 12(1+u) = 12 * xi."""
    k = v.prog.const(12)
    m = v.mul_xi()
    return F2(m.c0 * k, m.c1 * k)


def g2_complete_add(prog: Prog, p1, p2):
    """(X3:Y3:Z3) = P1 + P2 on the G2 curve, complete (RCB 2016 algorithm 7
    over Fq2; a = 0, b3 = 12(1+u)). E'(Fq2) has odd order (h2 and r are both
    odd), so the formulas are complete for EVERY on-curve point — doubling,
    infinity (0:1:0), and non-subgroup points included. That completeness is
    what lets the subgroup-check and cofactor ladders below run with a
    static, branch-free schedule on adversarial inputs."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2

    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)  # X1Y2 + X2Y1
    t4 = (Y1 + Z1) * (Y2 + Z2)
    t4 = t4 - (t1 + t2)  # Y1Z2 + Y2Z1
    X3 = (X1 + Z1) * (X2 + Z2)
    Y3 = X3 - (t0 + t2)  # X1Z2 + X2Z1
    X3 = t0 + t0
    t0 = X3 + t0  # 3 X1X2
    t2 = _f2_mul_b3(t2)
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = _f2_mul_b3(Y3)
    X3 = t4 * Y3
    t2 = t3 * t1
    X3 = t2 - X3
    Y3 = Y3 * t0
    t1 = t1 * Z3
    Y3 = t1 + Y3
    t0 = t0 * t3
    Z3 = Z3 * t4
    Z3 = Z3 + t0
    return (X3, Y3, Z3)


def g2_neg(p):
    X, Y, Z = p
    return (X, Y.neg(), Z)


def g2_scalar_mul_abs_x(prog: Prog, p):
    """[|x|]P (x the BLS parameter) via complete double-and-add over the
    STATIC msb-first bit string — 63 doublings + 5 additions, no selects."""
    acc = p
    for bit in ABS_X_BITS[1:]:
        acc = g2_complete_add(prog, acc, acc)
        if bit:
            acc = g2_complete_add(prog, acc, p)
    return acc


_PSI_CX_INTS = (_PSI_CX.c0, _PSI_CX.c1)
_PSI_CY_INTS = (_PSI_CY.c0, _PSI_CY.c1)


def g2_psi(prog: Prog, p):
    """p-power endomorphism on projective G2 points: the affine map
    (x, y) -> (cx * conj(x), cy * conj(y)) lifts to
    (X:Y:Z) -> (cx conj(X) : cy conj(Y) : conj(Z)) because conj is a field
    automorphism of Fq2/Fq (so it commutes with the X/Z, Y/Z divisions)."""
    X, Y, Z = p
    return (
        X.conj().mul_const(_PSI_CX_INTS),
        Y.conj().mul_const(_PSI_CY_INTS),
        Z.conj(),
    )


def _emit_g2_subgroup_check(prog: Prog, ns: str) -> None:
    """psi criterion (oracle utils/bls12_381.py is_in_g2_subgroup): an
    on-curve affine P is in the order-r subgroup iff psi(P) == -[|x|]P.
    Emits the comparison CROSS-MULTIPLIED (psi(P) has Z = 1): outputs
    d.0..d.3 are the Fq coefficients of psi_x*Q_Z - Q_X and psi_y*Q_Z + Q_Y
    for Q = [|x|]P — the host checks all four are 0 mod p. If the ladder
    lands on infinity (0:Y:0) the d.2/d.3 outputs equal psi_y*0 + Y != 0,
    matching the oracle's False for that case."""
    x = f2_inputs(prog, f"{ns}pt.x")
    y = f2_inputs(prog, f"{ns}pt.y")
    one = f2_const(prog, 1, 0)
    q = g2_scalar_mul_abs_x(prog, (x, y, one))
    px = x.conj().mul_const(_PSI_CX_INTS)
    py = y.conj().mul_const(_PSI_CY_INTS)
    dx = px * q[2] - q[0]
    dy = py * q[2] + q[1]
    prog.out(dx.c0, f"{ns}d.0")
    prog.out(dx.c1, f"{ns}d.1")
    prog.out(dy.c0, f"{ns}d.2")
    prog.out(dy.c1, f"{ns}d.3")


def build_g2_subgroup_check(fold: int = 1) -> Prog:
    """Codec program: batched G2 subgroup membership via the psi criterion.
    Inputs pt.{x,y}.{0,1} (affine Fq2, must be ON the curve — decompression
    guarantees that); outputs d.0..d.3 (all 0 mod p iff member)."""
    prog = Prog()
    if fold == 1:
        _emit_g2_subgroup_check(prog, "")
    else:
        for t in range(fold):
            _emit_g2_subgroup_check(prog, f"i{t}.")
    return prog


_R_BITS = [int(b) for b in bin(_R_ORDER)[2:]]


def _emit_g1_subgroup_check(prog: Prog, ns: str) -> None:
    """Definitional [r]P ladder with complete additions (E(Fq) also has odd
    order, so the static schedule is exception-free on every on-curve
    input). Output rz is the projective Z of [r]P: 0 mod p iff member."""
    x = prog.inp(f"{ns}pt.x")
    y = prog.inp(f"{ns}pt.y")
    p = (x, y, prog.const(1))
    acc = p
    for bit in _R_BITS[1:]:
        acc = g1_complete_add(prog, acc, acc)
        if bit:
            acc = g1_complete_add(prog, acc, p)
    prog.out(acc[2], f"{ns}rz")


def build_g1_subgroup_check(fold: int = 1) -> Prog:
    """Codec program: batched G1 subgroup membership ([r]P == infinity).
    Inputs pt.{x,y} (affine Fq, on curve); output rz (0 mod p iff member)."""
    prog = Prog()
    if fold == 1:
        _emit_g1_subgroup_check(prog, "")
    else:
        for t in range(fold):
            _emit_g1_subgroup_check(prog, f"i{t}.")
    return prog


def _f2_horner(prog: Prog, coeffs, x: F2) -> F2:
    """Evaluate sum_i coeffs[i] x^i (coeffs are oracle Fq2 constants)."""
    acc = f2_const(prog, coeffs[-1].c0, coeffs[-1].c1)
    for c in reversed(coeffs[:-1]):
        acc = acc * x + f2_const(prog, c.c0, c.c1)
    return acc


def _emit_iso_map_g2(prog: Prog, x: F2, y: F2):
    """RFC 9380 3-isogeny E'_SSWU -> G2 curve, PROJECTIVELY: with
    x_E = x_num/x_den and y_E = y * y_num/y_den, the image is
    (X:Y:Z) = (x_num*y_den : y*y_num*x_den : x_den*y_den) — no inversion
    anywhere on device; the host divides once per batch at the end."""
    xn = _f2_horner(prog, ISO_X_NUM, x)
    xd = _f2_horner(prog, ISO_X_DEN, x)
    yn = _f2_horner(prog, ISO_Y_NUM, x)
    yd = _f2_horner(prog, ISO_Y_DEN, x)
    return (xn * yd, y * (yn * xd), xd * yd)


def _emit_h2g_finish(prog: Prog, ns: str) -> None:
    q0x = f2_inputs(prog, f"{ns}q0.x")
    q0y = f2_inputs(prog, f"{ns}q0.y")
    q1x = f2_inputs(prog, f"{ns}q1.x")
    q1y = f2_inputs(prog, f"{ns}q1.y")
    p0 = _emit_iso_map_g2(prog, q0x, q0y)
    p1 = _emit_iso_map_g2(prog, q1x, q1y)
    r = g2_complete_add(prog, p0, p1)
    # clear_cofactor: the Budroni-Pintore psi decomposition, identical to
    # the oracle's clear_cofactor_g2:
    #   [h_eff]P = [x^2]P + [-x]P - P - [-x]psi(P) - psi(P) + psi(psi(2P))
    t1 = g2_scalar_mul_abs_x(prog, r)          # [|x|]P = [-x]P
    txx = g2_scalar_mul_abs_x(prog, t1)        # [x^2]P
    psi_p = g2_psi(prog, r)
    t2 = g2_scalar_mul_abs_x(prog, psi_p)      # [-x]psi(P)
    psi2_2p = g2_psi(prog, g2_psi(prog, g2_complete_add(prog, r, r)))
    acc = g2_complete_add(prog, txx, t1)
    acc = g2_complete_add(prog, acc, g2_neg(r))
    acc = g2_complete_add(prog, acc, g2_neg(t2))
    acc = g2_complete_add(prog, acc, g2_neg(psi_p))
    acc = g2_complete_add(prog, acc, psi2_2p)
    for name, comp in zip(("x", "y", "z"), acc):
        prog.out(comp.c0, f"{ns}h.{name}.0")
        prog.out(comp.c1, f"{ns}h.{name}.1")


def build_h2g_finish(fold: int = 1) -> Prog:
    """Codec program: the device part of hash_to_g2 — 3-isogeny evaluation
    of both SSWU points, their addition, and cofactor clearing, all with
    complete projective arithmetic (the ~75% of hash-to-G2 field work that
    needs no data-dependent branching).

    Inputs q{0,1}.{x,y}.{0,1}: the two map_to_curve_sswu_g2 outputs (affine
    Fq2 on the isogenous curve, from the host's batched SSWU).
    Outputs h.{x,y,z}.{0,1}: the hashed G2 point, PROJECTIVE (x = X/Z,
    y = Y/Z) — the host converts a whole batch affine with one
    batch-inversion ladder."""
    prog = Prog()
    if fold == 1:
        _emit_h2g_finish(prog, "")
    else:
        for t in range(fold):
            _emit_h2g_finish(prog, f"i{t}.")
    return prog


# ---------------------------------------------------------------------------
# RLC combine (random-linear-combination batch verification)
# ---------------------------------------------------------------------------

# RLC scalar width: fresh ~128-bit exponents give a 2^-128 Schwartz-Zippel
# false-accept bound (ops/bls_backend.batch_verify_rlc docstring)
RLC_BITS = 128

# PROG A outputs are compressed but LOOSE (< 2^382, not < p); declaring the
# true magnitude lets the bound tracker insert the compresses this needs,
# and the host can then feed f straight from the PROG A readback with no
# per-item int canonicalization
RLC_F_BOUND = 1 << 382


def _emit_rlc_combine(prog: Prog, ns: str, n: int) -> None:
    """prod_i f_i^{r_i} for RUNTIME exponent bits — the square-and-multiply
    ladder of pairing._pow_fixed, but with the bits as inputs instead of
    constants. The conditional multiply is arithmetic, not a select:

        acc' = acc^2 * (1 + b*(f-1)) = acc^2 + b * (acc^2 * (f-1))

    i.e. square, dense-multiply by the loop-invariant (f-1), scale the 12
    coefficients by the bit, add back — every op CHAINS on the accumulator,
    so the greedy scheduler keeps live ranges short (the select form's
    input-ready multiplies all landed at step ~0 and sat live for thousands
    of steps, a measured 10x register-file blowup). The n ladders are
    emitted LEVEL-INTERLEAVED (bit t of every item before bit t+1 of any)
    so they advance in lockstep through the mul lanes, then a log-depth
    tree reduce multiplies the powered values into one Fq12."""
    one = prog.const(1)
    fm1s: List[List[Val]] = []
    bitss: List[List[Val]] = []
    for i in range(n):
        fc = [prog.inp(f"{ns}f{i}.{j}", bound=RLC_F_BOUND) for j in range(12)]
        # f - 1 in the flat w-basis differs from f only at coefficient 0
        fm1s.append([fc[0] - one] + fc[1:])
        bitss.append([prog.inp(f"{ns}r{i}.{t}") for t in range(RLC_BITS)])
    # first bit from acc = 1: acc = 1 + b*(f-1), the cheap 12-mul form
    accs = [
        [(bitss[i][0] * fm1s[i][0]) + one]
        + [bitss[i][0] * fm1s[i][j] for j in range(1, 12)]
        for i in range(n)
    ]
    for t in range(1, RLC_BITS):
        for i in range(n):
            s = f12_square(prog, accs[i])
            m = f12_mul(prog, s, fm1s[i])
            b = bitss[i][t]
            accs[i] = [s[j] + (b * m[j]) for j in range(12)]
    powered = accs
    while len(powered) > 1:
        nxt = [
            f12_mul(prog, powered[i], powered[i + 1])
            for i in range(0, len(powered) - 1, 2)
        ]
        if len(powered) % 2:
            nxt.append(powered[-1])
        powered = nxt
    for j in range(12):
        prog.out(powered[0][j], f"{ns}c.{j}")


def build_rlc_combine(n: int, fold: int = 1) -> Prog:
    """RLC combine program: prod_{i<n} f_i^{r_i} into ONE Fq12.

    Inputs per instance: f{i}.0..f{i}.11 (flat Fq12, LOOSE limbs accepted —
    feed PROG A outputs directly) and r{i}.0..r{i}.{RLC_BITS-1} (the
    exponent bits msb-first, each the canonical residue of 0 or 1).
    Outputs c.0..c.11. Inactive lanes pass f = 1 with all-zero bits (then
    f^r = 1, the product's identity). ``fold`` packs that many independent
    combines per program row, as in build_miller_product."""
    prog = Prog()
    if fold == 1:
        _emit_rlc_combine(prog, "", n)
    else:
        for t in range(fold):
            _emit_rlc_combine(prog, f"i{t}.", n)
    return prog


# ---------------------------------------------------------------------------
# width-for-depth hard-part variants: depth-lean cyclotomic
# squarings + windowed / Frobenius-decomposed exponentiation chains
# ---------------------------------------------------------------------------


def f12_cyclotomic_square_comps(prog: Prog, c: List[F2]) -> List[F2]:
    """Granger-Scott cyclotomic squaring, COMPONENT form in and out, with
    the critical path flattened to ~5 ALU levels (the flat-basis
    `f12_cyclotomic_square` costs ~11: comps round-trips, chained
    double/add tails, Karatsuba pre-adds).

    The trade is width for depth: every output coefficient is a balanced
    signed tree over schoolbook products whose constant factors (3x, 6x
    from the `3t +- 2c` recombination and the xi fold) are PREMULTIPLIED
    into one operand as const muls — one extra mul level replaces the
    two-level `(t - c).double() + t` tail and every Karatsuba pre-add.
    ~54 Fq muls per squaring instead of 27, which is free on a depth-bound
    schedule (the mul lanes idle ~95% of the time at fold 1) and exactly
    what the hard part's serial squaring spine needs.

    Bounds stay compress-free: products of <=2^385 operands land at
    ~p + 2^350, and every output is a <=6-term signed sum of those, so the
    fixed point is ~2^384 — well inside both sub preconditions and the
    15-limb capacity."""
    three = prog.const(3)
    six = prog.const(6)
    c0b0, c1b0, c0b1, c1b1, c0b2, c1b2 = c

    def dbl(v: Val) -> Val:
        return v + v

    def type_a(u: F2, v: F2, s: F2) -> F2:
        """3*(u^2 + xi*v^2) - 2s, depth 5."""
        a0 = (u.c0 * three) * u.c0
        a1 = (u.c1 * three) * u.c1
        b0 = (v.c0 * three) * v.c0
        b1 = (v.c1 * three) * v.c1
        cv = (v.c0 * six) * v.c1
        cu = (u.c0 * six) * u.c1
        d_u = a0 - a1
        d_v = b0 - b1
        w0 = (d_u + d_v) - (cv + dbl(s.c0))
        w1 = ((cu - dbl(s.c1)) + d_v) + cv
        return F2(w0, w1)

    def type_b(u: F2, v: F2, s: F2) -> F2:
        """6*(u*v) + 2s, depth 4."""
        p = (u.c0 * six) * v.c0
        q = (u.c1 * six) * v.c1
        r = (u.c0 * six) * v.c1
        t = (u.c1 * six) * v.c0
        return F2((p - q) + dbl(s.c0), (r + t) + dbl(s.c1))

    def type_c(u: F2, v: F2, s: F2) -> F2:
        """6*xi*(u*v) + 2s, depth 5."""
        p = (u.c0 * six) * v.c0
        q = (u.c1 * six) * v.c1
        r = (u.c0 * six) * v.c1
        t = (u.c1 * six) * v.c0
        d1 = p - q
        d2 = r + t
        return F2((d1 - d2) + dbl(s.c0), (d1 + d2) + dbl(s.c1))

    z0 = type_a(c0b0, c1b1, c0b0)
    z1 = type_a(c1b0, c0b2, c0b1)
    z2 = type_a(c0b1, c1b2, c0b2)
    z3 = type_c(c0b1, c1b2, c1b0)
    z4 = type_b(c0b0, c1b1, c1b1)
    z5 = type_b(c0b2, c1b0, c1b2)
    return [z0, z3, z1, z4, z2, z5]


def _cyc_pow_spine(prog: Prog, base: List[F2], e: int) -> List[Val]:
    """base^e (static positive exponent, unitary base) with the squaring
    SPINE kept off the multiply path: s_j = base^(2^j) is a pure chain of
    depth-5 cyclotomic squarings, and the set bits' terms fold into a flat
    running product as they appear. Gaps between set bits are >= 1
    squaring, so most product multiplies are absorbed into the spine's
    timeline instead of extending it — the critical path is ~5 levels per
    exponent bit plus ONE dense multiply tail, not a multiply per set bit.
    Returns the flat Fq12 product."""
    assert e > 0
    s = base
    acc: List[Val] = None
    nbits = e.bit_length()
    for j in range(nbits):
        if (e >> j) & 1:
            term = f12_from_comps(s)
            acc = term if acc is None else f12_mul(prog, acc, term)
        if j != nbits - 1:
            s = f12_cyclotomic_square_comps(prog, s)
    return acc


_ABS_X = -X_PARAM  # |x|, the positive BLS parameter magnitude


def _window_digits(e: int, w: int) -> List[int]:
    """MSB-first sliding-window recoding of a positive exponent: returns a
    list where 0 means "square" and an odd digit d means "square then
    multiply by base^d". The first entry is the leading digit (no squaring
    before it)."""
    bits = [int(b) for b in bin(e)[2:]]
    out: List[int] = []
    i = 0
    first = True
    while i < len(bits):
        if bits[i] == 0:
            out.append(0)
            i += 1
            continue
        # window of up to w bits ending in a 1
        j = min(i + w, len(bits))
        while bits[j - 1] == 0:
            j -= 1
        d = int("".join(map(str, bits[i:j])), 2)
        if first:
            out.append(-d)  # leading digit: load, no squarings yet
            first = False
        else:
            out.extend([0] * (j - i - 1))
            out.append(d)
        i = j
    return out


def _cyc_pow_window(prog: Prog, h: List[Val], e: int, w: int = 3) -> List[Val]:
    """h^e (static positive exponent, unitary h, flat in/out) via sliding-
    window exponentiation: the small odd-power table {h, h^3, ..} is
    precomputed in parallel WIDTH (its muls all hang off h and h^2, away
    from the ladder's critical path), the ladder itself runs depth-lean
    cyclotomic squarings in component form, and set bits collapse into
    one table multiply per window instead of one per bit."""
    digits = _window_digits(e, w)
    needed = sorted({abs(d) for d in digits if d} - {1})
    table = {1: h}
    if needed:
        h2 = f12_from_comps(f12_cyclotomic_square_comps(prog, f12_to_comps(h)))
        prev = h
        for d in range(3, needed[-1] + 1, 2):
            prev = f12_mul(prog, prev, h2)
            if d in needed:
                table[d] = prev
    acc: List[F2] = None
    for d in digits:
        if d < 0:  # leading digit
            acc = f12_to_comps(table[-d])
            continue
        acc = f12_cyclotomic_square_comps(prog, acc)
        if d:
            m = f12_mul(prog, f12_from_comps(acc), table[d])
            acc = f12_to_comps(m)
    return f12_from_comps(acc)


def _emit_hard_part_windowed(prog: Prog, ns: str) -> None:
    """The legacy HHT chain with windowed, depth-lean exponentiations:
    same `(x-1)^2 * (x+p) * (x^2+p^2-1) + 3` structure as
    `_emit_hard_part`, but every `g^|x|` ladder runs component-form
    cyclotomic squarings (5 levels vs ~11) with sliding-window table
    multiplies."""
    g = [prog.inp(f"{ns}g.{i}") for i in range(12)]

    def px(h):  # h^x = conj(h^|x|)
        return f12_conj(prog, _cyc_pow_window(prog, h, _ABS_X))

    def px1(h):  # h^(x-1) = conj(h^(|x|+1))
        return f12_conj(prog, _cyc_pow_window(prog, h, _ABS_X + 1))

    t0 = px1(px1(g))  # g^((x-1)^2)
    t1 = f12_mul(prog, px(t0), f12_frobenius(prog, t0, 1))
    t2 = px(px(t1))
    t2 = f12_mul(prog, t2, f12_frobenius(prog, t1, 2))
    t2 = f12_mul(prog, t2, f12_conj(prog, t1))
    res = f12_mul(prog, t2, f12_mul(prog, f12_square(prog, g), g))
    for i in range(12):
        prog.out(res[i], f"{ns}res.{i}")


def build_hard_part_windowed(fold: int = 1) -> Prog:
    """PROG B variant 'windowed': HHT with sliding-window ladders over
    depth-lean component-form cyclotomic squarings. Same I/O contract as
    build_hard_part (g.0..11 -> res.0..11). Critical path ~2.1x shorter
    than the bit-serial legacy chain; the Frobenius variant below goes
    further."""
    prog = Prog()
    if fold == 1:
        _emit_hard_part_windowed(prog, "")
    else:
        for t in range(fold):
            _emit_hard_part_windowed(prog, f"i{t}.")
    return prog


def _emit_hard_part_frobenius(prog: Prog, ns: str) -> None:
    """Frobenius-heavy decomposition of the hard part: write
    3*(p^4-p^2+1)/r = l0 + l1*p + l2*p^2 + l3*p^3 with
        l3 = (x-1)^2,  l2 = l3*x,  l1 = l3*(x^2-1),  l0 = l1*x + 3,
    so with A = g^((|x|+1)^2) (note (x-1)^2 = (|x|+1)^2 for the negative
    BLS x) and B = A^|x|, C = B^|x|, D = C^|x|:

        res = conj(D)*B*g^3 * frob(C*conj(A)) * frob^2(conj(B)) * frob^3(A)

    (conj == inverse on the cyclotomic subgroup, and the q-power Frobenius
    maps are coefficient conjugations/constant multiplies — depth ~2).
    The four chains are SEQUENTIAL squaring spines (127 + 3*63 squarings,
    the log2(l0) floor no addition chain can beat), but each spine is pure
    depth-5 cyclotomic squarings with the set-bit products deferred off
    the critical path (_cyc_pow_spine), so the whole program's critical
    path lands at ~1.8k levels — ~2.7x below the 4864-step legacy chain —
    while the extra width (schoolbook const-folded squarings, spine
    product terms) rides the idle mul lanes."""
    g = [prog.inp(f"{ns}g.{i}") for i in range(12)]
    gc = f12_to_comps(g)

    A = _cyc_pow_spine(prog, gc, (_ABS_X + 1) ** 2)
    B = _cyc_pow_spine(prog, f12_to_comps(A), _ABS_X)
    C = _cyc_pow_spine(prog, f12_to_comps(B), _ABS_X)
    D = _cyc_pow_spine(prog, f12_to_comps(C), _ABS_X)

    # g^3 = g^2 * g: the g^2 squaring CSEs against chain A's spine head,
    # so this costs one dense mul, parallel to the spines
    g2 = f12_from_comps(f12_cyclotomic_square_comps(prog, gc))
    g3 = f12_mul(prog, g2, g)

    e0 = f12_mul(prog, f12_mul(prog, f12_conj(prog, D), B), g3)
    e1 = f12_frobenius(prog, f12_mul(prog, C, f12_conj(prog, A)), 1)
    e2 = f12_frobenius(prog, f12_conj(prog, B), 2)
    e3 = f12_frobenius(prog, A, 3)
    res = f12_mul(prog, f12_mul(prog, e0, e1), f12_mul(prog, e2, e3))
    for i in range(12):
        prog.out(res[i], f"{ns}res.{i}")


def build_hard_part_frobenius(fold: int = 1) -> Prog:
    """PROG B variant 'frobenius': the lambda-decomposed hard part (see
    _emit_hard_part_frobenius). Same I/O contract as build_hard_part.
    This is the width-for-depth flagship: critical path ~2.7x below the
    legacy chain at ANY fold, and by fold 8 the schedule is work-bound
    ('balanced'), so pipelined rows convert the recovered depth into
    per-row throughput (ops/bls_backend._run_hard_part routes here by
    default via CONSENSUS_SPECS_TPU_HARD_PART)."""
    prog = Prog()
    if fold == 1:
        _emit_hard_part_frobenius(prog, "")
    else:
        for t in range(fold):
            _emit_hard_part_frobenius(prog, f"i{t}.")
    return prog


def _emit_hard_part(prog: Prog, ns: str) -> None:
    g = [prog.inp(f"{ns}g.{i}") for i in range(12)]

    t0 = f12_pow_x_minus_1(prog, f12_pow_x_minus_1(prog, g))  # g^((x-1)^2)
    t1 = f12_mul(prog, f12_pow_x(prog, t0), f12_frobenius(prog, t0, 1))
    t2 = f12_pow_x(prog, f12_pow_x(prog, t1))
    t2 = f12_mul(prog, t2, f12_frobenius(prog, t1, 2))
    t2 = f12_mul(prog, t2, f12_conj(prog, t1))
    res = f12_mul(prog, t2, f12_mul(prog, f12_square(prog, g), g))
    for i in range(12):
        prog.out(res[i], f"{ns}res.{i}")


def build_hard_part(fold: int = 1) -> Prog:
    """PROG B: HHT hard part on unitary g (12 inputs), outputs res (12).
    res == 1 iff g^((p^4-p^2+1)/r) == 1.

    The single-item schedule is severely depth-bound (~7% mul-lane
    utilization: long serial cyclotomic-squaring chains), so ``fold`` here
    is the big lever — 16 items per program saturate the lanes."""
    prog = Prog()
    if fold == 1:
        _emit_hard_part(prog, "")
    else:
        for t in range(fold):
            _emit_hard_part(prog, f"i{t}.")
    return prog


# ---------------------------------------------------------------------------
# builder registry
# ---------------------------------------------------------------------------

# Canonical kind -> builder map, the single resolution point of
# ops/bls_backend._program (the program cache). Every entry takes
# (k, fold); kinds with no per-item size ignore k. The lambdas LATE-bind
# the module-level names so a monkeypatched builder (tests) is honored.
BUILDERS = {
    "miller_product": lambda k, fold=1: build_miller_product(k, fold),
    "aggregate_verify": lambda k, fold=1: build_aggregate_verify_miller(k, fold),
    "hard_part": lambda k, fold=1: build_hard_part(fold),
    "hard_part_windowed": lambda k, fold=1: build_hard_part_windowed(fold),
    "hard_part_frobenius": lambda k, fold=1: build_hard_part_frobenius(fold),
    "rlc_combine": lambda k, fold=1: build_rlc_combine(k, fold),
    "g1_subgroup": lambda k, fold=1: build_g1_subgroup_check(fold),
    "g2_subgroup": lambda k, fold=1: build_g2_subgroup_check(fold),
    "h2g_finish": lambda k, fold=1: build_h2g_finish(fold),
}
