"""BLS12-381: fields, curves, pairing, hash-to-curve, serialization.

Ground-up pure-Python implementation replacing the reference's external
`py_ecc==5.2.0` dependency (reference: tests/core/pyspec/eth2spec/utils/bls.py:1-2).
This module is the CPU correctness oracle for the JAX/XLA TPU backend in
`consensus_specs_tpu.ops` — the TPU kernels are cross-checked bit-identically
against it (the same pattern the reference uses between py_ecc and milagro,
tests/generators/bls/main.py:80,108-114).

Contents:
- Fq / Fq2 / Fq6 / Fq12 tower (Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(u+1)),
  Fq12 = Fq6[w]/(w^2-v))
- G1 (E: y^2 = x^3+4 over Fq) and G2 (E': y^2 = x^3+4(u+1) over Fq2) in
  Jacobian coordinates
- optimal-ate pairing (Miller loop over the BLS parameter, final exponentiation
  with easy part + direct hard-part power)
- hash-to-curve on G2 per RFC 9380 suite BLS12381G2_XMD:SHA-256_SSWU_RO_
- ZCash-format point compression (48-byte G1 / 96-byte G2)
"""
from __future__ import annotations

import hashlib
import random
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # curve order
X_PARAM = -0xD201000000010000  # BLS parameter x (negative)
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE


# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------


class Fq:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return Fq(self.n + o.n)

    def __sub__(self, o):
        return Fq(self.n - o.n)

    def __mul__(self, o):
        return Fq(self.n * o.n)

    def __neg__(self):
        return Fq(-self.n)

    def inverse(self):
        return Fq(pow(self.n, P - 2, P))

    def is_zero(self):
        return self.n == 0

    def __eq__(self, o):
        return isinstance(o, Fq) and self.n == o.n

    def __hash__(self):
        return hash(self.n)

    @staticmethod
    def zero():
        return Fq(0)

    @staticmethod
    def one():
        return Fq(1)

    def __repr__(self):
        return f"Fq(0x{self.n:x})"


def fq_sqrt(n: int) -> Optional[int]:
    """Square root in Fq (p = 3 mod 4); None if non-residue."""
    if n == 0:
        return 0
    cand = pow(n, (P + 1) // 4, P)
    if cand * cand % P == n % P:
        return cand
    return None


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2 + 1)
# ---------------------------------------------------------------------------


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    def mul_int(self, k: int):
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self):
        a0, a1 = self.c0, self.c1
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def inverse(self):
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        ninv = pow(norm, P - 2, P)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def pow(self, e: int):
        result = FQ2_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> Optional["Fq2"]:
        """Square root via the 'complex method' (p = 3 mod 4); None if non-residue."""
        a, b = self.c0, self.c1
        if b == 0:
            s = fq_sqrt(a)
            if s is not None:
                return Fq2(s, 0)
            s = fq_sqrt(-a % P)
            if s is None:
                return None
            return Fq2(0, s)
        alpha = fq_sqrt((a * a + b * b) % P)
        if alpha is None:
            return None
        inv2 = (P + 1) // 2
        delta = (a + alpha) * inv2 % P
        x0 = fq_sqrt(delta)
        if x0 is None:
            delta = (a - alpha) % P * inv2 % P
            x0 = fq_sqrt(delta)
            if x0 is None:
                return None
        x1 = b * pow(2 * x0 % P, P - 2, P) % P
        cand = Fq2(x0, x1)
        if cand.square() == self:
            return cand
        return None

    @staticmethod
    def zero():
        return FQ2_ZERO

    @staticmethod
    def one():
        return FQ2_ONE

    def __repr__(self):
        return f"Fq2(0x{self.c0:x}, 0x{self.c1:x})"


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
XI = Fq2(1, 1)  # the sextic-twist non-residue (1 + u)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - XI)
# ---------------------------------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        # (c0 + c1 v + c2 v^2) * v = c2*XI + c0 v + c1 v^2
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inverse(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - a1 * a2 * XI
        t1 = a2.square() * XI - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + (a2 * t1 + a1 * t2) * XI
        dinv = denom.inverse()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))

    @staticmethod
    def zero():
        return Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)

    @staticmethod
    def one():
        return Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        return self * self

    def conjugate(self):
        """x -> x^(p^6): the nontrivial automorphism of Fq12/Fq6."""
        return Fq12(self.c0, -self.c1)

    def inverse(self):
        denom = (self.c0.square() - self.c1.square().mul_by_v()).inverse()
        return Fq12(self.c0 * denom, -self.c1 * denom)

    def pow(self, e: int):
        if e < 0:
            return self.inverse().pow(-e)
        result = Fq12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    @staticmethod
    def zero():
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    def frobenius(self):
        """x -> x^p using precomputed tower coefficients."""
        c0 = _fq6_frob(self.c0)
        c1 = _fq6_frob(self.c1)
        # w^p = w * XI^((p-1)/6)
        c1 = Fq6(c1.c0 * FROB_W, c1.c1 * FROB_W, c1.c2 * FROB_W)
        return Fq12(c0, c1)


# Frobenius coefficients, computed (not hardcoded) at import:
# v^p = v * XI^((p-1)/3), v^2p = v^2 * XI^(2(p-1)/3), w^p = w * XI^((p-1)/6)
FROB_V1 = XI.pow((P - 1) // 3)
FROB_V2 = XI.pow(2 * (P - 1) // 3)
FROB_W = XI.pow((P - 1) // 6)


def _fq6_frob(a: Fq6) -> Fq6:
    return Fq6(a.c0.conjugate(), a.c1.conjugate() * FROB_V1, a.c2.conjugate() * FROB_V2)


# ---------------------------------------------------------------------------
# elliptic curve (Jacobian, a = 0); generic over the field element type
# ---------------------------------------------------------------------------

# A point is None (infinity) or a tuple (X, Y, Z) of field elements.


def ec_double(pt):
    if pt is None:
        return None
    X, Y, Z = pt
    if Y.is_zero():
        return None
    A = X * X
    B = Y * Y
    C = B * B
    t = X + B
    D = (t * t - A - C) + (t * t - A - C)  # 2*((X+B)^2 - A - C)
    E = A + A + A
    F = E * E
    X3 = F - (D + D)
    eight_c = C + C
    eight_c = eight_c + eight_c
    eight_c = eight_c + eight_c
    Y3 = E * (D - X3) - eight_c
    Z3 = (Y * Z) + (Y * Z)
    return (X3, Y3, Z3)


def ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = Z1 * Z1
    Z2Z2 = Z2 * Z2
    U1 = X1 * Z2Z2
    U2 = X2 * Z1Z1
    S1 = Y1 * Z2 * Z2Z2
    S2 = Y2 * Z1 * Z1Z1
    if U1 == U2:
        if S1 == S2:
            return ec_double(p1)
        return None
    H = U2 - U1
    I = (H + H) * (H + H)
    J = H * I
    rr = (S2 - S1) + (S2 - S1)
    V = U1 * I
    X3 = rr * rr - J - (V + V)
    Y3 = rr * (V - X3) - (S1 * J + S1 * J)
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H
    return (X3, Y3, Z3)


def ec_neg(pt):
    if pt is None:
        return None
    X, Y, Z = pt
    return (X, -Y, Z)


def ec_mul(pt, k: int):
    if k < 0:
        return ec_mul(ec_neg(pt), -k)
    result = None
    addend = pt
    while k:
        if k & 1:
            result = ec_add(result, addend)
        addend = ec_double(addend)
        k >>= 1
    return result


def ec_to_affine(pt):
    if pt is None:
        return None
    X, Y, Z = pt
    zinv = Z.inverse()
    zinv2 = zinv * zinv
    return (X * zinv2, Y * zinv2 * zinv)


def ec_from_affine(aff):
    if aff is None:
        return None
    x, y = aff
    one = type(x).one() if hasattr(type(x), "one") else Fq.one()
    return (x, y, one)


def ec_eq(p1, p2) -> bool:
    """Equality of Jacobian points (cross-multiplied, no inversion)."""
    if p1 is None or p2 is None:
        return p1 is None and p2 is None
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = Z1 * Z1
    Z2Z2 = Z2 * Z2
    if not (X1 * Z2Z2 == X2 * Z1Z1):
        return False
    return Y1 * Z2 * Z2Z2 == Y2 * Z1 * Z1Z1


G1_GEN = ec_from_affine((Fq(G1_X), Fq(G1_Y)))
G2_GEN = ec_from_affine((Fq2(G2_X0, G2_X1), Fq2(G2_Y0, G2_Y1)))

B_G1 = Fq(4)
B_G2 = Fq2(4, 4)  # 4 * (1 + u)


def is_on_curve_g1(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    return y * y == x * x * x + B_G1


def is_on_curve_g2(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    return y * y == x * x * x + B_G2


def is_in_g1_subgroup(pt) -> bool:
    return ec_mul(pt, R) is None


def is_in_g2_subgroup(pt) -> bool:
    """G2 membership via the psi-endomorphism criterion (Scott, 'A note on
    group membership tests'): P is in the order-r subgroup of E'(Fq2) iff
    psi(P) == [x]P, x the (negative) BLS parameter. One 64-bit scalar
    multiply instead of a 255-bit one; agrees with the definitional
    [r]P == infinity check on every tested member and non-member
    (tests/test_bls.py)."""
    if ec_to_affine(pt) is None:
        return True
    return ec_to_affine(psi_g2(pt)) == ec_to_affine(
        ec_neg(ec_mul(pt, -X_PARAM))
    )


def _is_in_g2_subgroup_scalar(pt) -> bool:
    """The definitional path — kept as the cross-check oracle."""
    return ec_mul(pt, R) is None


# the cofactors, #E(Fq) = G1_COFACTOR * R and #E'(Fq2) = G2_COFACTOR * R,
# from the BLS parameter x (G1: (x - 1)^2 / 3; G2: the twist's polynomial
# in x over 9)
G1_COFACTOR = (X_PARAM - 1) ** 2 // 3
G2_COFACTOR = (X_PARAM**8 - 4 * X_PARAM**7 + 5 * X_PARAM**6
               - 4 * X_PARAM**4 + 6 * X_PARAM**3 - 4 * X_PARAM**2
               - 4 * X_PARAM + 13) // 9


def curve_point(group: int, rng: random.Random):
    """A point of E (group 1) or the twist E' (group 2), Jacobian, at the
    first x drawn from ``rng`` with a square root: in general off the
    order-R subgroup."""
    while True:
        if group == 1:
            x = Fq(rng.randrange(P))
            y = fq_sqrt((x.n**3 + 4) % P)
            y = None if y is None else Fq(y)
        else:
            x = Fq2(rng.randrange(P), rng.randrange(P))
            y = (x * x * x + B_G2).sqrt()
        if y is not None:
            return ec_from_affine((x, y))


def off_subgroup_points(group: int, n: int, seed: int):
    """n affine points of E (group 1) or E' (group 2) off the order-R
    subgroup, from seeded x coordinates, each of an order that R divides
    (cofactor * P is not infinity), so R * P takes the generic addition at
    every set bit of R after the first."""
    inside, cofactor = ((is_in_g1_subgroup, G1_COFACTOR) if group == 1
                        else (is_in_g2_subgroup, G2_COFACTOR))
    rng = random.Random(seed)
    points = []
    while len(points) < n:
        pt = curve_point(group, rng)
        if not inside(pt) and ec_mul(pt, cofactor) is not None:
            points.append(ec_to_affine(pt))
    return points


def point_of_order(group: int, k: int, seed: int):
    """An affine point of prime order k on E (group 1) or E' (group 2),
    for a k that divides the cofactor (3 on G1, 13 on G2): a curve point's
    k-power part (m P, m the group order with every factor k taken out)
    times k until the next product would be infinity. Such a point meets
    Q and -Q inside a double-and-add over a few bits."""
    m = (G1_COFACTOR if group == 1 else G2_COFACTOR) * R
    if m % k:
        raise ValueError(f"no point of order {k} on group {group}")
    while m % k == 0:
        m //= k
    rng = random.Random(seed)
    while True:
        pt = ec_mul(curve_point(group, rng), m)
        if pt is not None:
            while ec_mul(pt, k) is not None:
                pt = ec_mul(pt, k)
            return ec_to_affine(pt)


# ---------------------------------------------------------------------------
# pairing
# ---------------------------------------------------------------------------


def _embed_fq(a: Fq) -> Fq12:
    return Fq12(Fq6(Fq2(a.n, 0), FQ2_ZERO, FQ2_ZERO), Fq6.zero())


def _embed_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, FQ2_ZERO, FQ2_ZERO), Fq6.zero())


# w and its powers for the untwist map: (x, y) on E' -> (x/w^2, y/w^3) on E(Fq12)
_W = Fq12(Fq6.zero(), Fq6.one())
_W2_INV = (_W * _W).inverse()
_W3_INV = (_W * _W * _W).inverse()


def untwist(q_aff) -> Tuple[Fq12, Fq12]:
    x, y = q_aff
    return (_embed_fq2(x) * _W2_INV, _embed_fq2(y) * _W3_INV)


def _line(p1, p2, t):
    """Evaluate the line through p1, p2 (affine E(Fq12) points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 == x2):
        m = (y2 - y1) * (x2 - x1).inverse()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        three = Fq(3)
        m = (_embed_fq(three) * x1 * x1) * (y1 + y1).inverse()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _aff_add12(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        three = Fq(3)
        m = (_embed_fq(three) * x1 * x1) * (y1 + y1).inverse()
    elif x1 == x2:
        return None
    else:
        m = (y2 - y1) * (x2 - x1).inverse()
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


_ATE_BITS = bin(-X_PARAM)[2:]  # MSB-first bits of |x|


def miller_loop(q_aff_g2, p_aff_g1) -> Fq12:
    """Miller loop f_{|x|,Q}(P); caller applies the negative-x conjugation."""
    if q_aff_g2 is None or p_aff_g1 is None:
        return Fq12.one()
    Q = untwist(q_aff_g2)
    Pt = (_embed_fq(p_aff_g1[0]), _embed_fq(p_aff_g1[1]))
    T = Q
    f = Fq12.one()
    for bit in _ATE_BITS[1:]:
        f = f * f * _line(T, T, Pt)
        T = _aff_add12(T, T)
        if bit == "1":
            f = f * _line(T, Q, Pt)
            T = _aff_add12(T, Q)
    # x < 0: conjugate (equivalent to inversion after final exponentiation)
    return f.conjugate()


_FINAL_EXP_HARD = (P**4 - P**2 + 1) // R


def final_exponentiate(f: Fq12) -> Fq12:
    # easy part: f^((p^6-1)(p^2+1))
    f = f.conjugate() * f.inverse()
    f = f.frobenius().frobenius() * f
    # hard part: f^((p^4 - p^2 + 1)/r)
    return f.pow(_FINAL_EXP_HARD)


def pairing(q_aff_g2, p_aff_g1, final_exp: bool = True) -> Fq12:
    """e(P, Q) with P in G1 (affine (Fq, Fq)), Q in G2 (affine (Fq2, Fq2))."""
    f = miller_loop(q_aff_g2, p_aff_g1)
    return final_exponentiate(f) if final_exp else f


def multi_pairing(pairs) -> Fq12:
    """prod e(P_i, Q_i) with one shared final exponentiation."""
    f = Fq12.one()
    for (p_g1, q_g2) in pairs:
        f = f * miller_loop(q_g2, p_g1)
    return final_exponentiate(f)


# ---------------------------------------------------------------------------
# serialization (ZCash format)
# ---------------------------------------------------------------------------

FLAG_COMPRESSED = 0x80
FLAG_INFINITY = 0x40
FLAG_SIGN = 0x20


def _fq_sign_is_large(y: int) -> bool:
    return y > (P - 1) // 2


def _fq2_sign_is_large(y: Fq2) -> bool:
    # lexicographic: compare c1 first, then c0
    ny0, ny1 = (-y.c0) % P, (-y.c1) % P
    return (y.c1, y.c0) > (ny1, ny0)


def g1_to_bytes(pt) -> bytes:
    aff = ec_to_affine(pt) if (pt is not None and len(pt) == 3) else pt
    if aff is None:
        return bytes([FLAG_COMPRESSED | FLAG_INFINITY]) + b"\x00" * 47
    x, y = aff
    flags = FLAG_COMPRESSED | (FLAG_SIGN if _fq_sign_is_large(y.n) else 0)
    data = bytearray(x.n.to_bytes(48, "big"))
    data[0] |= flags
    return bytes(data)


def g1_from_bytes(data: bytes):
    """Decompress 48-byte G1 point; raises ValueError on invalid encoding.

    Returns affine (Fq, Fq) or None for infinity. No subgroup check.
    """
    if len(data) != 48:
        raise ValueError("G1 point must be 48 bytes")
    flags = data[0]
    if not (flags & FLAG_COMPRESSED):
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & FLAG_INFINITY:
        if (flags & FLAG_SIGN) or any(b for b in bytes([data[0] & 0x1F]) + data[1:]):
            raise ValueError("invalid infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y2 = (x * x % P * x + 4) % P
    y = fq_sqrt(y2)
    if y is None:
        raise ValueError("G1 x not on curve")
    if bool(flags & FLAG_SIGN) != _fq_sign_is_large(y):
        y = P - y
    return (Fq(x), Fq(y))


def g2_to_bytes(pt) -> bytes:
    aff = ec_to_affine(pt) if (pt is not None and len(pt) == 3) else pt
    if aff is None:
        return bytes([FLAG_COMPRESSED | FLAG_INFINITY]) + b"\x00" * 95
    x, y = aff
    flags = FLAG_COMPRESSED | (FLAG_SIGN if _fq2_sign_is_large(y) else 0)
    data = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    data[0] |= flags
    return bytes(data)


def g2_from_bytes(data: bytes):
    """Decompress 96-byte G2 point; raises ValueError on invalid encoding."""
    if len(data) != 96:
        raise ValueError("G2 point must be 96 bytes")
    flags = data[0]
    if not (flags & FLAG_COMPRESSED):
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & FLAG_INFINITY:
        if (flags & FLAG_SIGN) or any(bytes([data[0] & 0x1F]) + data[1:]):
            raise ValueError("invalid infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = Fq2(x0, x1)
    y2 = x * x * x + B_G2
    y = y2.sqrt()
    if y is None:
        raise ValueError("G2 x not on curve")
    if bool(flags & FLAG_SIGN) != _fq2_sign_is_large(y):
        y = -y
    return (x, y)


# ---------------------------------------------------------------------------
# hash-to-curve G2: RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_
# ---------------------------------------------------------------------------

L_FIELD = 64  # bytes per field-element draw


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        raise ValueError("DST too long")
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * 64  # SHA-256 block size
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b_vals = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        tmp = bytes(a ^ b for a, b in zip(b0, b_vals[-1]))
        b_vals.append(hashlib.sha256(tmp + bytes([i]) + dst_prime).digest())
    return b"".join(b_vals)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes) -> List[Fq2]:
    len_in_bytes = count * 2 * L_FIELD
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            offset = L_FIELD * (j + i * 2)
            tv = uniform[offset : offset + L_FIELD]
            coeffs.append(int.from_bytes(tv, "big") % P)
        out.append(Fq2(coeffs[0], coeffs[1]))
    return out


def _sgn0_fq2(x: Fq2) -> int:
    sign_0 = x.c0 % 2
    zero_0 = x.c0 == 0
    sign_1 = x.c1 % 2
    return sign_0 or (zero_0 and sign_1)


# SSWU curve E': y^2 = x^3 + A'x + B'
SSWU_A = Fq2(0, 240)
SSWU_B = Fq2(1012, 1012)
SSWU_Z = Fq2(-2 % P, -1 % P)  # Z = -(2 + u)


def map_to_curve_sswu_g2(u: Fq2) -> Tuple[Fq2, Fq2]:
    """Simplified SWU onto the isogenous curve E' (RFC 9380 6.6.2)."""
    u2 = u.square()
    tv1 = SSWU_Z * u2
    tv2 = tv1.square() + tv1
    if tv2.is_zero():
        x1 = SSWU_B * (SSWU_Z * SSWU_A).inverse()
    else:
        x1 = (-SSWU_B) * SSWU_A.inverse() * (FQ2_ONE + tv2.inverse())
    gx1 = x1.square() * x1 + SSWU_A * x1 + SSWU_B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = tv1 * x1
        gx2 = x2.square() * x2 + SSWU_A * x2 + SSWU_B
        y2 = gx2.sqrt()
        if y2 is None:  # cannot happen for valid parameters
            raise ValueError("SSWU: no square root found")
        x, y = x2, y2
    if _sgn0_fq2(u) != _sgn0_fq2(y):
        y = -y
    return (x, y)


# 3-isogeny map E' -> E (RFC 9380 Appendix E.3)
_ISO_K = 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6
ISO_X_NUM = [
    Fq2(_ISO_K, _ISO_K),
    Fq2(0, 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    Fq2(0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1, 0),
]
ISO_X_DEN = [
    Fq2(0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63),
    Fq2(0xC, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
    FQ2_ONE,
]
ISO_Y_NUM = [
    Fq2(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    Fq2(0, 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    Fq2(0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10, 0),
]
ISO_Y_DEN = [
    Fq2(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    Fq2(0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3),
    Fq2(0x12, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99),
    FQ2_ONE,
]


def _horner(coeffs: List[Fq2], x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def iso_map_g2(x: Fq2, y: Fq2) -> Tuple[Fq2, Fq2]:
    x_num = _horner(ISO_X_NUM, x)
    x_den = _horner(ISO_X_DEN, x)
    y_num = _horner(ISO_Y_NUM, x)
    y_den = _horner(ISO_Y_DEN, x)
    return (x_num * x_den.inverse(), y * y_num * y_den.inverse())


# psi endomorphism on the twist E'(Fq2): untwist -> Frobenius -> twist.
# psi(x, y) = (PSI_CX * conj(x), PSI_CY * conj(y)); constants are
# 1/xi^((p-1)/3) and 1/xi^((p-1)/2) for the M-twist xi = 1 + u.
_PSI_CX = XI.pow((P - 1) // 3).inverse()
_PSI_CY = XI.pow((P - 1) // 2).inverse()


def psi_g2(pt):
    """The p-power endomorphism on E'(Fq2) (affine in, affine out as a
    Jacobian with Z=1 for composition with the ec_* ops)."""
    aff = ec_to_affine(pt)
    if aff is None:
        return pt
    x, y = aff
    return ec_from_affine((_PSI_CX * x.conjugate(), _PSI_CY * y.conjugate()))


_X_ABS = 0xD201000000010000  # |x|, the BLS parameter magnitude (x = -|x|)


def clear_cofactor_g2(pt):
    """[H_EFF_G2] * pt via the psi-endomorphism decomposition
    (Budroni-Pintore; RFC 9380 picked H_EFF_G2 so that

        [h_eff]P = [x^2 - x - 1]P + [x - 1]psi(P) + psi(psi(2P))

    holds EXACTLY for every point of E'(Fq2), not just the subgroup).
    Replaces the 636-bit scalar multiply with three 64-bit multiplies —
    ~6x faster, bit-identical (cross-checked against the scalar-multiply
    path in tests/test_bls.py)."""
    t1 = ec_mul(pt, _X_ABS)          # [-x]P
    txx = ec_mul(t1, _X_ABS)         # [x^2]P
    psi_p = psi_g2(pt)
    t2 = ec_mul(psi_p, _X_ABS)       # [-x]psi(P)
    psi2_2p = psi_g2(psi_g2(ec_double(pt)))
    # [x^2 - x - 1]P = txx + t1 - P;  [x - 1]psi(P) = -t2 - psi(P)
    acc = ec_add(txx, t1)
    acc = ec_add(acc, ec_neg(pt))
    acc = ec_add(acc, ec_neg(t2))
    acc = ec_add(acc, ec_neg(psi_p))
    return ec_add(acc, psi2_2p)


def _clear_cofactor_g2_scalar(pt):
    """The definitional path (636-bit scalar multiply) — kept as the
    cross-check oracle for clear_cofactor_g2."""
    return ec_mul(pt, H_EFF_G2)


def hash_to_g2(msg: bytes, dst: bytes):
    """hash_to_curve per RFC 9380; returns Jacobian point in the G2 subgroup."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = iso_map_g2(*map_to_curve_sswu_g2(u0))
    q1 = iso_map_g2(*map_to_curve_sswu_g2(u1))
    r_pt = ec_add(ec_from_affine(q0), ec_from_affine(q1))
    return clear_cofactor_g2(r_pt)
