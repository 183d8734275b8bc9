"""Optimal-ate pairing on BLS12-381 over ops/towers.py: inversion-free and
batched, the counterpart of consensus_specs_tpu/ops/pairing.py, limb for
limb.

The Miller loop runs with T in Jacobian coordinates on the twist E'(Fq2)
and P in G1 affine (Fq scalars). Line functions are evaluated WITHOUT
field inversions by scaling each line with the Fq2 denominators (elements
of subfields are killed by the final exponentiation, so scaling by any
Fq2* factor is sound). With the oracle's untwist convention
(x, y) -> (x/w^2, y/w^3), the scaled lines are:

doubling at T=(X,Y,Z), eval at P=(xp,yp)   [slope 3X^2/(2YZ)]:
    l = -2*Y*Z^3*yp * XI   (tower slot 1)
      + 3*X^2*Z^2*xp       (tower slot v^2*w)
      + (2*Y^2 - 3*X^3)    (tower slot v*w)

addition T + Q, Q=(xq,yq) affine, slope R/(H*Z), H = xq Z^2 - X, R = yq Z^3 - Y:
    l = -yp*H*Z * XI       (slot 1)
      + R*xp               (slot v^2*w)
      + (yq*H*Z - R*xq)    (slot v*w)

(substitute the untwist into the affine line and scale by XI times the
denominator; XI = 1+u.) So the Miller output equals the oracle's up to an
Fq2 subfield factor, which the final exponentiation kills.

Two final exponentiations decide f^((p^12-1)/r) == 1: the reference-slow
``final_exp_is_one_full`` (square-and-multiply over the whole ~4314-bit
exponent, no inversion) and the structured ``final_exp_is_one`` (easy
part with one Fq12 inversion, then the Hayashida-Hayasaka-Teruya hard
part). Every ``lax.scan`` of the JAX package over static bits is a loop
over the bits here: a set bit takes the multiply (or the addition step),
a clear bit keeps the accumulator (the select's other side), so the limbs
are the JAX package's. Every Fq product is one ``fq.mont_mul``: on the
card, a launch of the Montgomery kernel.

``rlc_combine`` is the tower twin of the VM program
``vmlib.build_rlc_combine`` (the backend's ``_rlc_combine_tower``).
"""
import torch

from ..utils.bls12_381 import P, R, X_PARAM
from . import towers as tw
from .curve import FQ2_OPS, double, point

_ATE_BITS = [int(b) for b in bin(-X_PARAM)[2:]][1:]  # skip MSB
_FINAL_EXP = (P**12 - 1) // R
_FINAL_EXP_BITS = [int(b) for b in bin(_FINAL_EXP)[2:]][1:]  # skip MSB


def _dbl_step(T, xp, yp):
    """Double T and return (line, T2). xp/yp: Fq tensors (G1 affine)."""
    X, Y, Z = T["x"], T["y"], T["z"]
    X2 = tw.fq2_square(X)  # X^2
    A3 = tw.fq2_add(tw.fq2_add(X2, X2), X2)  # 3X^2
    Y2 = tw.fq2_square(Y)  # Y^2
    Z2 = tw.fq2_square(Z)
    Z3 = tw.fq2_mul(Z2, Z)
    YZ3 = tw.fq2_mul(Y, Z3)
    two_YZ3 = tw.fq2_add(YZ3, YZ3)

    xi = tw.fq2_const(1, 1, X.shape[:-2], device=X.device)
    # line components (see module docstring)
    c_1 = tw.fq2_mul_scalar(tw.fq2_neg(tw.fq2_mul(two_YZ3, xi)), yp)
    c_v2w = tw.fq2_mul_scalar(tw.fq2_mul(A3, Z2), xp)
    c_vw = tw.fq2_sub(tw.fq2_add(Y2, Y2), tw.fq2_mul(A3, X))

    line = tw.fq12_from_tower_components(c_1, c_vw, c_v2w)
    T2 = double(FQ2_OPS, T)
    return line, T2


def _add_step(T, qx, qy, xp, yp):
    """Add affine Q to T and return (line, T+Q)."""
    X, Y, Z = T["x"], T["y"], T["z"]
    Z2 = tw.fq2_square(Z)
    Z3 = tw.fq2_mul(Z2, Z)
    U2 = tw.fq2_mul(qx, Z2)
    S2 = tw.fq2_mul(qy, Z3)
    H = tw.fq2_sub(U2, X)
    Rr = tw.fq2_sub(S2, Y)
    HZ = tw.fq2_mul(H, Z)

    xi = tw.fq2_const(1, 1, X.shape[:-2], device=X.device)
    c_1 = tw.fq2_mul_scalar(tw.fq2_neg(tw.fq2_mul(HZ, xi)), yp)
    c_v2w = tw.fq2_mul_scalar(Rr, xp)
    c_vw = tw.fq2_sub(tw.fq2_mul(qy, HZ), tw.fq2_mul(Rr, qx))

    line = tw.fq12_from_tower_components(c_1, c_vw, c_v2w)

    # mixed addition (generic path; T == +-Q cannot occur mid-Miller-loop)
    H2 = tw.fq2_square(H)
    H3 = tw.fq2_mul(H2, H)
    V = tw.fq2_mul(X, H2)
    R2 = tw.fq2_square(Rr)
    X3 = tw.fq2_sub(tw.fq2_sub(R2, H3), tw.fq2_add(V, V))
    Y3 = tw.fq2_sub(tw.fq2_mul(Rr, tw.fq2_sub(V, X3)), tw.fq2_mul(Y, H3))
    Z3n = HZ
    return line, point(X3, Y3, Z3n)


def miller_loop(qx, qy, px, py):
    """f_{|x|}(Q, P) followed by the negative-x conjugation.

    qx, qy: (..., 2, L) Fq2 affine twist coords of Q (must not be infinity)
    px, py: (..., L) Fq affine coords of P (must not be infinity)
    Returns flat Fq12 (..., 12, L). On a clear bit the JAX package
    multiplies f by the selected identity and keeps T; so does this, and
    skips the addition step whose outputs that select drops."""
    batch = px.shape[:-1]
    one2 = tw.fq2_const(1, 0, batch, device=px.device)
    T = point(qx, qy, one2)
    f = tw.fq12_one(batch, px.device)
    ident = f
    for bit in _ATE_BITS:
        f = tw.fq12_square(f)
        line, T = _dbl_step(T, px, py)
        f = tw.fq12_mul(f, line)
        if bit:
            line2, T = _add_step(T, qx, qy, px, py)
        else:
            line2 = ident
        f = tw.fq12_mul(f, line2)
    # x < 0: conjugate (inversion up to final exponentiation)
    return tw.fq12_conjugate(f)


def _pow_fixed(f, bits_msb_first):
    """f^e for a STATIC bit list: square, and multiply on a set bit."""
    acc = f  # the MSB is absorbed by the start
    for bit in bits_msb_first[1:]:
        acc = tw.fq12_square(acc)
        if bit:
            acc = tw.fq12_mul(acc, f)
    return acc


def final_exp_is_one_full(f):
    """Reference-slow path: f^((p^12-1)/r) == 1 by square-and-multiply
    over the full ~4314-bit exponent. Kept for cross-checking the
    structured version."""
    return tw.fq12_is_one(_pow_fixed(f, [1] + _FINAL_EXP_BITS))


_ABS_X_BITS = [int(b) for b in bin(-X_PARAM)[2:]]
_ABS_X_PLUS_1_BITS = [int(b) for b in bin(-X_PARAM + 1)[2:]]


def _unitary_pow_x(g):
    """g^x for unitary g (x = BLS parameter, negative): conj(g^|x|)."""
    return tw.fq12_conjugate(_pow_fixed(g, _ABS_X_BITS))


def _unitary_pow_x_minus_1(g):
    """g^(x-1) for unitary g: x-1 = -(|x|+1), so conj(g^(|x|+1))."""
    return tw.fq12_conjugate(_pow_fixed(g, _ABS_X_PLUS_1_BITS))


def final_exp_is_one(f):
    """f^((p^12-1)/r) == 1, structured.

    Easy part: g = f^((p^6-1)(p^2+1)) (one general Fq12 inversion; g lands
    in the cyclotomic subgroup, where inverse == conjugate).
    Hard part: Hayashida-Hayasaka-Teruya decomposition
        3*(p^4-p^2+1)/r = (x-1)^2 * (x+p) * (x^2+p^2-1) + 3
    The extra factor 3 is sound: f^E lies in the order-r subgroup and
    gcd(3, r) = 1, so cubing is a bijection there and g^(3E') == 1 iff
    g^E' == 1. Returns bool (...,).
    """
    # easy part
    g = tw.fq12_mul(tw.fq12_conjugate(f), tw.fq12_inv(f))  # f^(p^6-1)
    g = tw.fq12_mul(tw.fq12_frobenius(g, 2), g)  # ^(p^2+1)

    # hard part: m = g^((x-1)^2)
    t0 = _unitary_pow_x_minus_1(_unitary_pow_x_minus_1(g))
    # ^(x+p)
    t1 = tw.fq12_mul(_unitary_pow_x(t0), tw.fq12_frobenius(t0, 1))
    # ^(x^2+p^2-1)
    t2 = _unitary_pow_x(_unitary_pow_x(t1))
    t2 = tw.fq12_mul(t2, tw.fq12_frobenius(t1, 2))
    t2 = tw.fq12_mul(t2, tw.fq12_conjugate(t1))
    # * g^3
    res = tw.fq12_mul(t2, tw.fq12_mul(tw.fq12_square(g), g))
    return tw.fq12_is_one(res)


def rlc_combine(fs: torch.Tensor, rs_bits: torch.Tensor) -> torch.Tensor:
    """Random-linear-combination combine: prod_i f_i^{r_i} as ONE Fq12.

    fs: (N, 12, 15) flat Fq12 batch (loose Montgomery limbs); rs_bits:
    (N, B) exponent bits, msb-first, on fs' device. Returns (12, 15). Each
    item runs the square-and-multiply ladder with its bits as RUNTIME
    values (a select per item per bit, one Python step per bit column in
    place of the JAX package's ``lax.scan``); the powered values then
    tree-reduce pairwise into one element. Every Fq12 product is one
    batched ``fq.mont_mul``: the CUDA kernel on the card."""
    n = fs.shape[0]
    ident = tw.fq12_one((n,), fs.device)
    acc = ident
    for bit_col in rs_bits.to(torch.bool).T:
        acc = tw.fq12_square(acc)
        acc = tw.fq12_mul(acc, tw.fq12_select(bit_col, fs, ident))
    # log-depth pairwise tree reduce of the N powered values
    while acc.shape[0] > 1:
        m = acc.shape[0] // 2
        head = tw.fq12_mul(acc[: 2 * m : 2], acc[1 : 2 * m : 2])
        acc = head if acc.shape[0] % 2 == 0 else torch.cat(
            [head, acc[-1:]], dim=0)
    return acc[0]


def pairing_product_is_one(pairs):
    """prod e(P_i, Q_i) == 1 for a list of (px, py, qx, qy) batched
    coordinates. The pairs' Miller loops run as ONE loop over the stacked
    pairs (each coordinate broadcast to the pairs' common shape; every
    row sees the same operations, so the limbs are those of the loops run
    one by one); the outputs multiply in list order."""
    px, py, qx, qy = (torch.stack(torch.broadcast_tensors(*col))
                      for col in zip(*pairs))
    fs = list(miller_loop(qx, qy, px, py).unbind(0))
    f = fs[0]
    for fi in fs[1:]:
        f = tw.fq12_mul(f, fi)
    return final_exp_is_one(f)
