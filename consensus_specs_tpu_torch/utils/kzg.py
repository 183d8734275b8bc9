"""The port's copy of the JAX package's utils/kzg.py.

KZG polynomial commitments + DAS erasure coding over the BLS12-381
scalar field (BASELINE config #5; reference specs/das/das-core.md:63-190 and
the sharding draft's commitment machinery,
specs/sharding/beacon-chain.md:85-175, 717-721).

Own implementation in exact integer arithmetic over the curve order r
("MODULUS" in the draft specs): radix-2 (I)FFT, reverse-bit-order helpers,
the DAS extension/recovery pair, KZG commit/prove/verify for single points
and subgroup cosets (multi-proofs), and the sharding degree check. The
elliptic-curve side rides the repo's oracle (utils/bls12_381); batched
device verification is ops/kzg_backend.py (the pairing plane is the same one the
signature path uses — SURVEY §2.7/P6).

``construct_proofs`` computes per-coset multiproofs by direct polynomial
division — the FK20 batch construction the draft references is an encoder
optimization, not a semantic change.
"""
from typing import List, Optional, Sequence

from . import bls12_381 as curve
from .bls12_381 import G1_GEN, G2_GEN, R as MODULUS, ec_add, ec_mul, ec_neg

PRIMITIVE_ROOT_OF_UNITY = 5  # (sharding/beacon-chain.md:104)


def root_of_unity(order: int) -> int:
    assert order & (order - 1) == 0, "order must be a power of two"
    assert (MODULUS - 1) % order == 0
    return pow(PRIMITIVE_ROOT_OF_UNITY, (MODULUS - 1) // order, MODULUS)


def is_power_of_two(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def reverse_bit_order(n: int, order: int) -> int:
    # (das-core.md:66-73)
    assert is_power_of_two(order)
    bits = order.bit_length() - 1
    out = 0
    for _ in range(bits):
        out = (out << 1) | (n & 1)
        n >>= 1
    return out


def reverse_bit_order_list(elements: Sequence) -> List:
    # (das-core.md:75-81)
    order = len(elements)
    assert is_power_of_two(order)
    return [elements[reverse_bit_order(i, order)] for i in range(order)]


# ---------------------------------------------------------------------------
# FFT over F_r
# ---------------------------------------------------------------------------


def fft(coeffs: Sequence[int], omega: int = None) -> List[int]:
    """Evaluate the polynomial given by ``coeffs`` at the powers of omega
    (iterative radix-2, bit-reversal order internally)."""
    n = len(coeffs)
    assert is_power_of_two(n)
    if omega is None:
        omega = root_of_unity(n)
    a = [c % MODULUS for c in reverse_bit_order_list(list(coeffs))]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, MODULUS)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for i in range(start, start + half):
                u, v = a[i], a[i + half] * w % MODULUS
                a[i] = (u + v) % MODULUS
                a[i + half] = (u - v) % MODULUS
                w = w * w_len % MODULUS
        length <<= 1
    return a


def inverse_fft(evals: Sequence[int], omega: int = None) -> List[int]:
    n = len(evals)
    if omega is None:
        omega = root_of_unity(n)
    inv_n = pow(n, MODULUS - 2, MODULUS)
    out = fft(evals, pow(omega, MODULUS - 2, MODULUS))
    return [x * inv_n % MODULUS for x in out]


def das_fft_extension(data: Sequence[int]) -> List[int]:
    """Odd-index IFFT inputs making the second half of coefficients zero
    (das-core.md:89-97)."""
    poly = inverse_fft(data)
    return fft(list(poly) + [0] * len(poly))[1::2]


def extend_data(data: Sequence[int]) -> List[int]:
    # (das-core.md:113-121)
    rev_bit_odds = reverse_bit_order_list(
        das_fft_extension(reverse_bit_order_list(list(data)))
    )
    return list(data) + rev_bit_odds


def unextend_data(extended_data: Sequence[int]) -> List[int]:
    return list(extended_data[: len(extended_data) // 2])


def recover_data(subgroups: Sequence[Optional[Sequence[int]]]) -> List[int]:
    """Recover the full reverse-bit-ordered evaluation vector from >= half of
    its subgroup-aligned ranges (das-core.md:103-111).

    Exact Lagrange interpolation over the known evaluation points — O(n^2)
    but exact; the n·log^2(n) FFT-based recovery the draft links is an
    optimization of the same map."""
    sample_count = len(subgroups)
    assert is_power_of_two(sample_count)
    points_per = None
    for s in subgroups:
        if s is not None:
            points_per = len(s)
            break
    assert points_per is not None
    n = sample_count * points_per
    flat: List[Optional[int]] = [None] * n
    for si, sub in enumerate(subgroups):
        if sub is None:
            continue
        for j, y in enumerate(sub):
            flat[si * points_per + j] = y
    return recover_data_points(flat)


def recover_data_points(values: Sequence[Optional[int]]) -> List[int]:
    """Point-level recovery: ``values[i]`` is the evaluation at omega^i or
    None; any >= n/2 known points determine the (degree < n/2) polynomial.
    Raises if the known points are mutually inconsistent."""
    n = len(values)
    assert is_power_of_two(n)
    omega = root_of_unity(n)

    known = [(i, v % MODULUS) for i, v in enumerate(values) if v is not None]
    assert len(known) >= n // 2, "need at least half the points"

    xs = [pow(omega, i, MODULUS) for i, _ in known[: n // 2]]
    ys = [v for _, v in known[: n // 2]]
    coeffs = _lagrange_coeffs(xs, ys)
    assert len(coeffs) <= n // 2
    coeffs = coeffs + [0] * (n - len(coeffs))
    out = fft(coeffs, omega)
    # consistency: recovered values must agree with EVERY known point
    for i, v in known:
        assert out[i] == v, "inconsistent samples"
    return out


def _lagrange_coeffs(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Coefficients of the unique degree<len(xs) polynomial through points."""
    n = len(xs)
    # master product M(X) = prod (X - x_i)
    master = [1]
    for x in xs:
        master = _poly_mul(master, [(-x) % MODULUS, 1])
    coeffs = [0] * n
    for i in range(n):
        # basis_i = M / (X - x_i), scaled by 1 / basis_i(x_i)
        basis = _poly_div_linear(master, xs[i])
        denom = _poly_eval(basis, xs[i])
        scale = ys[i] * pow(denom, MODULUS - 2, MODULUS) % MODULUS
        for k in range(len(basis)):
            coeffs[k] = (coeffs[k] + basis[k] * scale) % MODULUS
    while len(coeffs) > 1 and coeffs[-1] == 0:
        coeffs.pop()
    return coeffs


def _poly_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % MODULUS
    return out


def _poly_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % MODULUS
    return acc


def _poly_div_linear(coeffs, x0):
    """Quotient of coeffs / (X - x0) by synthetic division (the remainder —
    P(x0) — is dropped; callers divide where it is zero or irrelevant)."""
    n = len(coeffs)
    out = [0] * (n - 1)
    carry = coeffs[-1] % MODULUS
    for i in range(n - 2, -1, -1):
        out[i] = carry
        carry = (coeffs[i] + carry * x0) % MODULUS
    return out


# ---------------------------------------------------------------------------
# trusted setup + commitments (sharding/beacon-chain.md:168-175)
# ---------------------------------------------------------------------------


class Setup:
    """INSECURE testing setup from a known tau — the production setup comes
    from a ceremony; same shape as G1_SETUP/G2_SETUP."""

    def __init__(self, tau: int, n: int):
        self.n = n
        self.g1 = []
        self.g2 = []
        acc = 1
        for _ in range(n):
            self.g1.append(ec_mul(G1_GEN, acc))
            self.g2.append(ec_mul(G2_GEN, acc))
            acc = acc * tau % MODULUS


class _LazyPoints:
    """Indexable view of [tau^i]G computed on demand: the mainnet-shape setup
    is 16,384 points per group (MAX_SAMPLES_PER_BLOB * POINTS_PER_SAMPLE,
    sharding/beacon-chain.md:168-175) and the degree check only ever touches
    a handful of indices, so eager construction would be pure waste."""

    def __init__(self, gen, tau: int, n: int):
        self._gen = gen
        self._tau = tau
        self.n = n
        self._cache = {}

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError(f"setup index {i} out of range (n={self.n})")
        if i not in self._cache:
            self._cache[i] = ec_mul(self._gen, pow(self._tau, i, MODULUS))
        return self._cache[i]

    def __iter__(self):
        return (self[i] for i in range(self.n))


class LazySetup:
    """Setup-compatible (``.n``/``.g1``/``.g2``) with on-demand points."""

    def __init__(self, tau: int, n: int):
        self.n = n
        self.g1 = _LazyPoints(G1_GEN, tau, n)
        self.g2 = _LazyPoints(G2_GEN, tau, n)


_lazy_setup_cache: dict = {}


def lazy_setup(tau: int, n: int) -> LazySetup:
    """Cached per (tau, n) so spec modules and test helpers share one
    point cache."""
    if (tau, n) not in _lazy_setup_cache:
        _lazy_setup_cache[(tau, n)] = LazySetup(tau, n)
    return _lazy_setup_cache[(tau, n)]


def commit_to_poly(setup: Setup, coeffs: Sequence[int]):
    """C = sum c_i * [tau^i]G1 (an MSM — the device analog is a G1 reduction
    over the batch axis, the same shape as pubkey aggregation).

    Zero coefficients are skipped before touching the setup so lazy setups
    only materialize the points a sparse polynomial (e.g. the degree-proof
    shift) actually uses."""
    assert len(coeffs) <= setup.n
    acc = None
    for i, c in enumerate(coeffs):
        if c % MODULUS:
            acc = ec_add(acc, ec_mul(setup.g1[i], c % MODULUS))
    return acc if acc is not None else ec_mul(G1_GEN, 0)


def commit_to_data(setup: Setup, data: Sequence[int]):
    """Commit to evaluation-form data (das-core.md commit_to_data)."""
    return commit_to_poly(setup, inverse_fft(reverse_bit_order_list(list(data))))


def _commit_g2(setup: Setup, coeffs: Sequence[int]):
    assert len(coeffs) <= setup.n
    acc = None
    for i, c in enumerate(coeffs):
        if c % MODULUS:
            acc = ec_add(acc, ec_mul(setup.g2[i], c % MODULUS))
    return acc if acc is not None else ec_mul(G2_GEN, 0)


def _poly_sub(a, b):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % MODULUS
            for i in range(n)]


def _poly_divmod(num, den):
    num = list(num)
    out = [0] * max(1, len(num) - len(den) + 1)
    inv_lead = pow(den[-1], MODULUS - 2, MODULUS)
    for i in reversed(range(len(out))):
        if len(num) < len(den) + i:
            continue
        q = num[len(den) - 1 + i] * inv_lead % MODULUS
        out[i] = q
        for j, d in enumerate(den):
            num[i + j] = (num[i + j] - q * d) % MODULUS
    while len(num) > 1 and num[-1] == 0:
        num.pop()
    return out, num


def prove_at_point(setup: Setup, coeffs: Sequence[int], z: int):
    """KZG witness for p(z): commit((p(X) - p(z)) / (X - z))."""
    y = _poly_eval(coeffs, z)
    q, rem = _poly_divmod(_poly_sub(list(coeffs), [y]), [(-z) % MODULUS, 1])
    assert rem == [0]
    return commit_to_poly(setup, q), y


def verify_point_proof(setup: Setup, commitment, proof, z: int, y: int) -> bool:
    """e(C - [y]G1, G2) == e(pi, [tau - z]G2), as a product-of-pairings."""
    c_minus_y = ec_add(commitment, ec_neg(ec_mul(G1_GEN, y % MODULUS)))
    tau_minus_z = ec_add(setup.g2[1], ec_neg(ec_mul(G2_GEN, z % MODULUS)))
    res = curve.multi_pairing([
        (curve.ec_to_affine(c_minus_y), curve.ec_to_affine(G2_GEN)),
        (curve.ec_to_affine(ec_neg(proof)), curve.ec_to_affine(tau_minus_z)),
    ])
    return res == curve.Fq12.one()


def prove_coset(setup: Setup, coeffs: Sequence[int], x: int, coset_size: int):
    """Multi-proof for the coset {x*w^j}: commit((p - I) / Z) with
    Z = X^k - x^k and I interpolating p on the coset."""
    w = root_of_unity(coset_size)
    xs = [x * pow(w, j, MODULUS) % MODULUS for j in range(coset_size)]
    ys = [_poly_eval(coeffs, xi) for xi in xs]
    interp = _lagrange_coeffs(xs, ys)
    z_poly = [0] * (coset_size + 1)
    z_poly[0] = (-pow(x, coset_size, MODULUS)) % MODULUS
    z_poly[coset_size] = 1
    q, rem = _poly_divmod(_poly_sub(list(coeffs), interp), z_poly)
    assert all(r == 0 for r in rem), "coset evaluations inconsistent"
    return commit_to_poly(setup, q), ys


def check_multi_kzg_proof(setup: Setup, commitment, proof, x: int,
                          ys: Sequence[int]) -> bool:
    """Verify a coset multi-proof (das-core.md check_multi_kzg_proof):
    e(C - [I], G2) == e(pi, [Z(tau)]G2)."""
    coset_size = len(ys)
    w = root_of_unity(coset_size)
    xs = [x * pow(w, j, MODULUS) % MODULUS for j in range(coset_size)]
    interp = _lagrange_coeffs(xs, [y % MODULUS for y in ys])
    c_minus_i = ec_add(commitment, ec_neg(commit_to_poly(setup, interp)))
    z_poly = [0] * (coset_size + 1)
    z_poly[0] = (-pow(x, coset_size, MODULUS)) % MODULUS
    z_poly[coset_size] = 1
    z_at_tau_g2 = _commit_g2(setup, z_poly)
    res = curve.multi_pairing([
        (curve.ec_to_affine(c_minus_i), curve.ec_to_affine(G2_GEN)),
        (curve.ec_to_affine(ec_neg(proof)), curve.ec_to_affine(z_at_tau_g2)),
    ])
    return res == curve.Fq12.one()


def verify_degree_proof(setup: Setup, commitment, degree_proof,
                        points_count: int) -> bool:
    """The sharding draft's degree check
    (reference specs/sharding/beacon-chain.md:717-721):
    e(degree_proof, G2[0]) == e(commitment, G2[n - points_count]) proves
    deg(p) < points_count, with degree_proof = commit(p * X^(n - points_count))."""
    # a points_count above n would make the shift negative and (for lazy
    # setups) wrap Python-style to an unrelated point; 0 would index g2[n].
    # Reject both — don't wrap, don't IndexError
    assert 0 < points_count <= setup.n, "points_count outside 1..setup.n"
    shift = setup.n - points_count
    res = curve.multi_pairing([
        (curve.ec_to_affine(degree_proof), curve.ec_to_affine(setup.g2[0])),
        (curve.ec_to_affine(ec_neg(commitment)), curve.ec_to_affine(setup.g2[shift])),
    ])
    return res == curve.Fq12.one()


def degree_proof(setup: Setup, coeffs: Sequence[int], points_count: int):
    """commit(p(X) * X^(n - points_count)) — only exists when
    deg(p) < points_count."""
    assert len(coeffs) <= points_count
    assert 0 <= points_count <= setup.n, "points_count exceeds setup size"
    shift = setup.n - points_count
    shifted = [0] * shift + [c % MODULUS for c in coeffs]
    return commit_to_poly(setup, shifted)
