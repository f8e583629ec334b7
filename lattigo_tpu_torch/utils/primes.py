"""NTT-friendly prime generation and primitive-root search (host only).

Same contract as :mod:`lattigo_tpu.utils.primes` (primes ≡ 1 mod NthRoot
walking outward from 2^bit_size, alternating up/down; primitive roots via
the factorisation of q-1), so both packages draw identical moduli. The
number theory is self-contained: a deterministic Miller–Rabin test (exact
for every n < 2^64 with the first twelve prime bases) and Pollard–Brent
factorisation, with no dependency beyond the standard library.
"""

from __future__ import annotations

import math
import random

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(x: int) -> bool:
    if x < 2:
        return False
    for p in _MR_BASES:
        if x % p == 0:
            return x == p
    if x >= 1 << 64:
        raise ValueError("is_prime is exact only below 2^64")
    d, s = x - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _MR_BASES:
        y = pow(a, d, x)
        if y in (1, x - 1):
            continue
        for _ in range(s - 1):
            y = y * y % x
            if y == x - 1:
                break
        else:
            return False
    return True


def _pollard_brent(n: int, rng: random.Random) -> int:
    """A non-trivial factor of the odd composite n."""
    while True:
        y, c, m = rng.randrange(1, n), rng.randrange(1, n), 128
        g = r = q = 1
        x = ys = y
        while g == 1:
            x = y
            for _ in range(r):
                y = (y * y + c) % n
            k = 0
            while k < r and g == 1:
                ys = y
                for _ in range(min(m, r - k)):
                    y = (y * y + c) % n
                    q = q * abs(x - y) % n
                g = math.gcd(q, n)
                k += m
            r *= 2
        if g == n:
            g = 1
            while g == 1:
                ys = (ys * ys + c) % n
                g = math.gcd(abs(x - ys), n)
        if g != n:
            return g


def prime_factors(n: int) -> list[int]:
    """Distinct prime factors of n, ascending."""
    out: set[int] = set()
    for p in (2, 3, 5, 7, 11, 13):
        while n % p == 0:
            out.add(p)
            n //= p
    stack = [n] if n > 1 else []
    rng = random.Random(0)
    while stack:
        m = stack.pop()
        if is_prime(m):
            out.add(m)
            continue
        f = _pollard_brent(m, rng)
        stack += [f, m // f]
    return sorted(out)


class NTTFriendlyPrimesGenerator:
    """Generates primes ≡ 1 mod NthRoot, alternating above/below 2^bit_size."""

    def __init__(self, bit_size: int, nth_root: int):
        if nth_root <= 0 or nth_root & (nth_root - 1):
            raise ValueError(f"nth_root must be a power of two, got {nth_root}")
        if bit_size > 61:
            raise ValueError(f"bit_size must be <= 61, got {bit_size}")
        self.bit_size = bit_size
        self.nth_root = nth_root
        center = 1 << bit_size
        self._next_up = center + 1
        self._next_down = center + 1 - nth_root
        self._prefer_up = True

    def _advance_up(self) -> int:
        while True:
            self._next_up += self.nth_root
            if self._next_up.bit_length() > self.bit_size + 1:
                raise ValueError("ran out of upstream primes for bit size")
            if is_prime(self._next_up):
                return self._next_up

    def _advance_down(self) -> int:
        while True:
            self._next_down -= self.nth_root
            if (self._next_down.bit_length() < self.bit_size
                    or self._next_down <= self.nth_root):
                raise ValueError("ran out of downstream primes for bit size")
            if is_prime(self._next_down):
                return self._next_down

    def next_alternating_prime(self) -> int:
        if self._prefer_up:
            self._prefer_up = False
            try:
                return self._advance_up()
            except ValueError:
                return self._advance_down()
        self._prefer_up = True
        try:
            return self._advance_down()
        except ValueError:
            return self._advance_up()

    def next_upstream_prime(self) -> int:
        return self._advance_up()

    def next_downstream_prime(self) -> int:
        return self._advance_down()

    def next_alternating_primes(self, k: int) -> list[int]:
        return [self.next_alternating_prime() for _ in range(k)]


def generate_ntt_primes(bit_size: int, nth_root: int, k: int) -> list[int]:
    """k balanced NTT-friendly primes of ~bit_size bits for a given 2N-th root."""
    return NTTFriendlyPrimesGenerator(bit_size, nth_root).next_alternating_primes(k)


def primitive_root(q: int, factors: list[int] | None = None) -> int:
    """Smallest generator of (Z/qZ)* for prime q."""
    if factors is None:
        factors = prime_factors(q - 1)
    order = q - 1
    g = 2
    while True:
        if all(pow(g, order // p, q) != 1 for p in factors):
            return g
        g += 1


def primitive_nth_root(q: int, n: int) -> int:
    """A primitive n-th root of unity mod prime q (requires n | q-1)."""
    if (q - 1) % n != 0:
        raise ValueError(f"{n} does not divide q-1 for q={q}")
    return pow(primitive_root(q), (q - 1) // n, q)
