"""Minimax (Remez) polynomial approximation over interval unions.

Counterpart of :mod:`lattigo_tpu.utils.minimax`, host-only numpy and
mpmath, copied expression for expression so that the coefficients are the
JAX package's bit for bit. One difference: where the JAX package's
``remez`` finds no solution at all (a singular first equioscillation
system) it returns nothing and its caller fails with a ``TypeError``; here
``remez`` raises a ``ValueError`` and ``gen_minimax_composite_sign`` names
the stage that failed.

Analog of ``utils/bignum/minimax_approximation.go`` (Remez
exchange with a big-float linear solver and extrema scanning, ref
minimax_approximation.go:15-805) and
``circuits/ckks/minimax/minimax_composite_polynomial.go``
(GenMinimaxCompositePolynomial): host-side tooling that produces the
polynomials consumed by the sign/comparison/inverse circuits.

Implementation: full-exchange Remez on a Chebyshev basis (odd-only basis
for sign-like targets). The (n+2)-point equioscillation system is solved
with mpmath at ``prec`` bits (default 212, cf. the reference's
prec=236-bit default for its sign tables) — the system becomes singular
in float64 once interval endpoints approach machine resolution (e.g.
sign on [2^-30, 1]). Extrema scanning runs in float64 Clenshaw over a
geometric grid, accurate to the ~2^-45 level the CKKS circuits consume.
"""

from __future__ import annotations

import numpy as np

from lattigo_tpu_torch.circuits.polynomial import CHEBYSHEV, Polynomial


def _cheb_cols(x: np.ndarray, degrees: list[int]) -> np.ndarray:
    """T_d(x) columns for d in degrees (valid for |x| slightly > 1 too)."""
    v = np.polynomial.chebyshev.chebvander(np.asarray(x, dtype=np.float64),
                                           max(degrees))
    return v[:, degrees]


def _cheb_cols_mp(xs, degrees, mp):
    """T_d(x) columns in mpmath precision via the 3-term recurrence."""
    dmax = max(degrees)
    rows = []
    for x in xs:
        t0, t1 = mp.mpf(1), mp.mpf(x)
        ts = [t0, t1]
        for _ in range(dmax - 1):
            ts.append(2 * mp.mpf(x) * ts[-1] - ts[-2])
        rows.append([ts[d] for d in degrees])
    return rows


def _dense_grid(intervals, points_per_interval=4000):
    """Chebyshev-spaced scan grid; geometric when an interval spans many
    octaves (sign on [2^-alpha, 1] needs resolution near the left end)."""
    xs = []
    for a, b in intervals:
        if a > 0 and b / a > 100:
            xs.append(np.geomspace(a, b, points_per_interval))
        elif b < 0 and a / b > 100:
            xs.append(-np.geomspace(-b, -a, points_per_interval)[::-1])
        else:
            xs.append(0.5 * (a + b) + 0.5 * (b - a)
                      * -np.cos(np.linspace(0, np.pi, points_per_interval)))
    return np.concatenate(xs)


def remez(f, intervals, degree: int, odd: bool = False,
          iters: int = 30, prec: int = 212,
          basis_interval: tuple[float, float] | None = None) -> Polynomial:
    """Minimax approximation of f over a union of intervals.

    Returns a Polynomial in Chebyshev basis over ``basis_interval``
    (default: the hull of the intervals). ``odd=True`` restricts to odd
    Chebyshev polynomials (sign-like targets; intervals must then be
    symmetric and only the positive part given). ``prec`` is the bit
    precision of the equioscillation solve (ref Remez uses big.Float).
    """
    from mpmath import mp as _mp

    lo = min(a for a, _ in intervals)
    hi = max(b for _, b in intervals)
    if odd:
        lo = -hi
    if basis_interval is None:
        basis_interval = (lo, hi)
    ba, bb = basis_interval
    scale = 2.0 / (bb - ba)

    def to_cheb(x):
        return (np.asarray(x, dtype=np.float64) - ba) * scale - 1.0

    degrees = (list(range(1, degree + 1, 2)) if odd
               else list(range(0, degree + 1)))
    n = len(degrees)

    grid = _dense_grid(intervals)
    fg = np.array([f(x) for x in grid])

    # initial reference: n+1 points distributed over the union by the
    # Chebyshev (arcsin) measure of [-1, 1] — equioscillation-friendly
    # even when an interval reaches machine-small endpoints (a uniform
    # pick clusters at the tiny end of a geometric grid and makes the
    # exchange diverge)
    hull_lo = min(a for a, _ in intervals)
    hull_hi = max(b for _, b in intervals)

    def to_hull_angle(x):
        u = (np.asarray(x, dtype=np.float64) - hull_lo) \
            * (2.0 / (hull_hi - hull_lo)) - 1.0
        return np.arcsin(np.clip(u, -1.0, 1.0))

    def from_hull_angle(t):
        return (np.sin(t) + 1.0) * ((hull_hi - hull_lo) / 2.0) + hull_lo

    measures = np.array([float(to_hull_angle(b) - to_hull_angle(a))
                         for a, b in intervals])
    counts = np.maximum(1, np.round(measures / measures.sum() * (n + 1))
                        .astype(int))
    while counts.sum() > n + 1:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n + 1:
        counts[np.argmax(measures)] += 1
    ref_parts = []
    for (a, b), c in zip(intervals, counts):
        ta, tb = float(to_hull_angle(a)), float(to_hull_angle(b))
        t = np.linspace(ta, tb, c + 2)[1:-1] if c < n + 1 else \
            np.linspace(ta, tb, c)
        ref_parts.append(from_hull_angle(t))
    ref = np.sort(np.concatenate(ref_parts))
    # snap to grid points so extrema bookkeeping stays consistent
    ref = grid[np.searchsorted(grid, ref).clip(0, len(grid) - 1)]

    coeffs = None
    with _mp.workprec(prec):
        for _ in range(iters):
            fr = [f(x) for x in ref]
            rows = _cheb_cols_mp(to_cheb(ref), degrees, _mp)
            mat = _mp.matrix(n + 1, n + 1)
            rhs = _mp.matrix(n + 1, 1)
            for i in range(n + 1):
                for j in range(n):
                    mat[i, j] = rows[i][j]
                mat[i, n] = (-1) ** i       # equioscillation column
                rhs[i] = _mp.mpf(fr[i])
            try:
                sol = _mp.lu_solve(mat, rhs)
            except ZeroDivisionError:       # degenerate reference set
                break
            coeffs = np.array([float(sol[j]) for j in range(n)])

            err = _cheb_cols(to_cheb(grid), degrees) @ coeffs - fg
            # pick n+1 alternating local extrema of |err|
            ext = [0]
            for i in range(1, len(grid) - 1):
                if (err[i] - err[i - 1]) * (err[i + 1] - err[i]) <= 0:
                    ext.append(i)
            ext.append(len(grid) - 1)
            ext = np.array(ext)
            # keep the n+1 largest alternating ones
            order = ext[np.argsort(-np.abs(err[ext]))]
            chosen: list[int] = []
            for i in sorted(order[: 4 * (n + 1)]):
                if not chosen or np.sign(err[i]) != np.sign(err[chosen[-1]]):
                    chosen.append(i)
                elif abs(err[i]) > abs(err[chosen[-1]]):
                    chosen[-1] = i
            if len(chosen) < n + 1:
                break
            best = np.array(chosen[: n + 1])
            new_ref = grid[best]
            if np.allclose(new_ref, ref, rtol=0, atol=1e-300):
                ref = new_ref
                break
            ref = new_ref

    if coeffs is None:
        raise ValueError("Remez found no solution: the equioscillation system "
                         "of the first reference set is singular")
    full = np.zeros(degree + 1, dtype=np.complex128)
    for d, c in zip(degrees, coeffs):
        full[d] = c
    return Polynomial(list(full), basis=CHEBYSHEV, interval=basis_interval)


def rebase_to_unit(poly: Polynomial) -> Polynomial:
    """Re-express a Chebyshev-basis polynomial over hull [a, b] in the
    Chebyshev basis of [-1, 1] (same polynomial function of x).

    The homomorphic evaluator generates its power basis directly from the
    ciphertext (T₁ = x), i.e. it evaluates in the [-1, 1] basis; use this
    for polynomials whose Remez hull differs (the sign generator below
    already produces [-1, 1]-basis output via ``basis_interval``).
    """
    a, b = poly.interval
    if (a, b) == (-1.0, 1.0):
        return poly
    cheb = np.polynomial.chebyshev
    mono = cheb.cheb2poly(np.asarray(poly.coeffs, dtype=np.complex128))
    # substitute t = (2x - (a+b))/(b-a) into p(t)
    comp = np.zeros(1, dtype=np.complex128)
    lin = np.array([-(a + b) / (b - a), 2.0 / (b - a)], dtype=np.complex128)
    for c in mono[::-1]:
        comp = np.polynomial.polynomial.polymul(comp, lin)
        if comp.size == 0:
            comp = np.zeros(1, dtype=np.complex128)
        comp[0] += c
    out = cheb.poly2cheb(comp)
    return Polynomial(list(out), basis=CHEBYSHEV, interval=(-1.0, 1.0))


def gen_minimax_composite_sign(alpha: int, degrees: list[int],
                               prec: int = 212) -> list[Polynomial]:
    """Composite minimax sign: p_k ∘ … ∘ p_1 ≈ sign on ±[2^-alpha, 1]
    (ref GenMinimaxCompositePolynomial, minimax_composite_polynomial.go:14).

    Each stage narrows the uncertainty band: stage i approximates sign on
    ±[eps_i, 1+delta] and its output lands within ±(1 ± eps_{i+1}). All
    stages are returned in the Chebyshev basis of [-1, 1], directly
    consumable by the homomorphic evaluator. The JAX package names alpha=12
    → [15, 15, 17, 31] and alpha=30 → [15, 15, 15, 17, 31, 31, 31, 31] (the
    reference's DefaultCompositePolynomialForSign schedule) as good
    schedules, but with this generator both raise the band error at stage
    1. Schedules that contract: (6, [15, 15]), (8, [15, 15, 15]),
    (8, [31, 15, 15]).

    Stage 0's own error is not checked (as in the JAX package). When it
    diverges, as degree 63 does at alpha 10 and 12, the next stage's
    interval spans many orders of magnitude, its first equioscillation
    system is singular, and the ``ValueError`` raised names that stage and
    the band stage 0 left.
    """
    polys = []
    eps = 2.0 ** -alpha
    lo = eps
    err_prev = 0.0
    for i, d in enumerate(degrees):
        hi = 1.0 + (0.0 if i == 0 else err_prev)
        try:
            p = remez(lambda x: 1.0, [(lo, hi)], d, odd=True, prec=prec,
                      basis_interval=(-1.0, 1.0))
        except ValueError as e:
            raise ValueError(
                f"composite stage {i} (degree {d}) on [{lo:.3g}, {hi:.3g}]: {e}"
                + (f" (stage {i - 1} left the band err={err_prev:.3g})"
                   if i else "")) from e
        # achieved error, measured on a dense grid and inflated by a
        # safety margin so the next stage's domain covers the true image
        # (the measured max can undershoot between grid points; the
        # reference handles the same slack via its logerr parameter)
        grid = _dense_grid([(lo, hi)], points_per_interval=20_000)
        vals = np.polynomial.chebyshev.chebval(
            grid, np.asarray(p.coeffs, dtype=np.complex128)).real
        err_prev = float(np.max(np.abs(vals - 1.0))) * 1.05 + 2.0 ** -49
        if err_prev >= 1.0 and i > 0:
            raise ValueError(
                f"composite stage {i} (degree {d}) cannot contract the "
                f"band (err={err_prev:.3f} ≥ 1); use a higher degree or "
                "more stages")
        polys.append(p)
        lo = max(1.0 - err_prev, 2.0 ** -50)
    return polys
