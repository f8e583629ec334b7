"""Han–Ki cosine interpolation for EvalMod (CosDiscrete).

Counterpart of :mod:`lattigo_tpu.utils.cosine`, copied expression for
expression so the coefficients are the same numbers (ref
``utils/cosine/cosine_approx.go``, ia.cr/2019/688, "Better Bootstrapping
for Approximate Homomorphic Encryption"): a polynomial approximation of
cos(2π(x − 0.25)/2^r) over x ∈ [−K, K] whose interpolation nodes cluster
in ±1/dev neighbourhoods of the integers — the only places EvalMod inputs
can land (dev = message ratio 2^{log_mr}). This reaches a given accuracy
at far lower degree than full-interval Chebyshev interpolation when
K/2^r > 1.

Returned coefficients are in the Chebyshev basis of the variable u = x/K,
so the homomorphic evaluation feeds |u| ≤ 1 and every power-basis value
|T_n(u)| ≤ 1 — the bootstrap's C2S scaling divides the EvalMod input by K
before the Chebyshev evaluation (ref bootstrapping/evaluator.go:190
C2SScaling=qDiv/(K·qDiff)). The Han–Ki interpolant is bounded by ~1 over
the whole of [−K, K], so the re-expansion coefficients are O(1); a
shrunk-interval variable v = x·2^r/K (|v| up to 2^r) would put values
T_30(2^r) ≈ 2^119 into the homomorphic power basis and turn rescale noise
into message-level error. The solve runs at 256-bit precision (mpmath),
matching the reference's cosine.EncodingPrecision.

All of this is host-side parameter generation; speed is irrelevant.
"""

from __future__ import annotations

import math

import numpy as np
from mpmath import mp, mpf, cos as mp_cos, pi as mp_pi

_PREC = 256  # bits, ref cosine_approx.go EncodingPrecision
_LOG2_2PI = math.log2(2 * math.pi)


def _gen_degrees(degree: int, k: int, dev: float):
    """Node count per interval [i ± 1/dev] (ref cosine_approx.go:82).

    Pure float64 bookkeeping, as in the reference (genDegrees uses float64).
    """
    degbdd = degree + 1
    totdeg = 2 * k - 1
    err = 1.0 / dev
    deg = [1] * k
    temp = 0.0
    for i in range(1, 2 * k):
        temp -= math.log2(i)
    temp += (2 * k - 1) * _LOG2_2PI
    temp += math.log2(err)
    bdd = [0.0] * k
    for i in range(k):
        bdd[i] = temp
        for j in range(1, k - i):
            bdd[i] += math.log2(j + err)
        for j in range(1, k + i):
            bdd[i] += math.log2(j + err)

    for _ in range(200):
        if totdeg >= degbdd:
            break
        maxi = int(np.argmax(bdd))
        if maxi != 0:
            if totdeg + 2 > degbdd:
                break
            for i in range(k):
                bdd[i] -= math.log2(totdeg + 1)
                bdd[i] -= math.log2(totdeg + 2)
                bdd[i] += 2.0 * _LOG2_2PI
                if i != maxi:
                    bdd[i] += math.log2(abs(i - maxi) + err)
                    bdd[i] += math.log2(i + maxi + err)
                else:
                    bdd[i] += math.log2(err) - 1.0
                    bdd[i] += math.log2(2.0 * i + err)
            totdeg += 2
        else:
            bdd[0] -= math.log2(totdeg + 1)
            bdd[0] += math.log2(err) - 1.0
            bdd[0] += _LOG2_2PI
            for i in range(1, k):
                bdd[i] -= math.log2(totdeg + 1)
                bdd[i] += _LOG2_2PI
                bdd[i] += math.log2(i + err)
            totdeg += 1
        deg[maxi] += 1
    return deg, totdeg


def _gen_nodes(deg, dev: float, totdeg: int, k: int, scnum: int):
    """Nodes ±i ± cos(πj/deg_i)/dev and f(nodes), 256-bit (ref :160)."""
    scfac = mpf(1 << scnum)
    inter = mpf(1) / mpf(dev)
    nodes = [mpf(0)] * totdeg
    cnt = 1 if deg[0] % 2 != 0 else 0
    for i in range(k - 1, 0, -1):
        for j in range(deg[i]):
            t = mp_cos(mp_pi * mpf(2 * j) / mpf(2 * deg[i])) * inter
            nodes[cnt] = mpf(i) + t
            cnt += 1
            nodes[cnt] = -nodes[cnt - 1]
            cnt += 1
    for j in range(deg[0] // 2):
        t = mp_cos(mp_pi * mpf(2 * j) / mpf(2 * deg[0])) * inter
        nodes[cnt] = t
        cnt += 1
        nodes[cnt] = -nodes[cnt - 1]
        cnt += 1
    y = [mp_cos(2 * mp_pi * (x - mpf(1) / 4) / scfac) for x in nodes]
    return nodes, y


def approximate_cos(k: int, degree: int, dev: float, scnum: int):
    """Chebyshev-basis coefficients (variable u = x/K, |u| ≤ 1) of the
    Han–Ki interpolant of cos(2π(x−0.25)/2^scnum) on [−K, K] (ref :30).

    Returns a list of mpmath mpf values — keep them high-precision until
    the final scale-embedding multiply.
    """
    with mp.workprec(_PREC):
        deg, totdeg = _gen_degrees(degree, k, dev)
        nodes, y = _gen_nodes(deg, dev, totdeg, k, scnum)

        # divided differences (Newton form), ref solve():248
        y = list(y)
        for j in range(1, totdeg):
            for i in range(totdeg - j):
                y[i] = (y[i + 1] - y[i]) / (nodes[i + j] - nodes[i])

        totdeg += 1
        kb = mpf(k)
        # Chebyshev sample points over the FULL [−K, K]: the re-expansion
        # variable must be u = x/K so the homomorphic power basis stays in
        # [−1, 1] (see module docstring). Exact polynomial identity: the
        # degree-(totdeg−1) interpolant is resampled at totdeg Chebyshev
        # points and re-solved in the T_n(u) basis.
        x = [kb * mp_cos(mp_pi * mpf(i) / mpf(totdeg - 1))
             for i in range(totdeg)]

        # evaluate the Newton interpolant at the x points
        p = [y[0]] * totdeg
        for i in range(totdeg):
            acc = y[0]
            for j in range(1, totdeg - 1):
                acc = acc * (x[i] - nodes[j]) + y[j]
            p[i] = acc

        # Chebyshev basis in u = x/K: build and solve T c = p
        n = totdeg
        v = [xi / kb for xi in x]
        T = [[mpf(0)] * n for _ in range(n)]
        for i in range(n):
            T[i][0] = mpf(1)
            T[i][1] = v[i]
            for j in range(2, n):
                T[i][j] = 2 * v[i] * T[i][j - 1] - T[i][j - 2]

        # Gaussian elimination with partial pivoting (ref solve():320)
        pv = list(p)
        for i in range(n - 1):
            mi = i
            mx = abs(T[i][i])
            for j in range(i + 1, n):
                if abs(T[j][i]) > mx:
                    mi, mx = j, abs(T[j][i])
            if mi != i:
                T[i], T[mi] = T[mi], T[i]
                pv[i], pv[mi] = pv[mi], pv[i]
            piv = T[i][i]
            for j in range(i + 1, n):
                T[i][j] /= piv
            pv[i] /= piv
            T[i][i] = mpf(1)
            for j2 in range(i + 1, n):
                f = T[j2][i]
                if f != 0:
                    pv[j2] -= f * pv[i]
                    for j in range(i + 1, n):
                        T[j2][j] -= f * T[i][j]
                    T[j2][i] = mpf(0)
        c = [mpf(0)] * n
        c[n - 1] = pv[n - 1] / T[n - 1][n - 1]
        for i in range(n - 2, -1, -1):
            acc = pv[i]
            for j in range(i + 1, n):
                acc -= T[i][j] * c[j]
            c[i] = acc
        return c[: totdeg - 1]
