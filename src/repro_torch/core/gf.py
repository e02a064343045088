"""Finite field GF(q) arithmetic for q = p^m (table based, small q).

The MMS / Slim Fly construction (paper §II-B) needs a commutative field
F_q with a primitive element xi.  For prime q this is Z_q; for prime powers
(q = 25, 27, 49, ...) we build GF(p^m) as polynomials over GF(p) modulo an
irreducible polynomial found by exhaustive search (q is small: the paper's
practical library tops out around q ~ 100).

Elements are encoded as integers in [0, q): the integer's base-p digits are
the polynomial coefficients (digit i = coefficient of x^i).

A numpy-only copy of `repro.core.gf`, kept so the port
imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GF", "is_prime", "factor_prime_power"]


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def factor_prime_power(q: int):
    """Return (p, m) with q == p**m, or None if q is not a prime power."""
    if q < 2:
        return None
    for p in range(2, q + 1):
        if p * p > q:
            break
        if q % p == 0:
            m, r = 0, q
            while r % p == 0:
                r //= p
                m += 1
            return (p, m) if r == 1 else None
    return (q, 1)  # q itself prime


def _poly_mul_mod(a: int, b: int, p: int, m: int, red: tuple) -> int:
    """Multiply two GF(p)[x] polynomials (base-p encoded) mod the monic
    irreducible `red` (tuple of m coefficients of x^0..x^{m-1}; x^m is
    implicitly reduced to -red)."""
    # polynomial coefficients
    ca = [(a // p**i) % p for i in range(m)]
    cb = [(b // p**i) % p for i in range(m)]
    prod = [0] * (2 * m - 1)
    for i, ai in enumerate(ca):
        if ai:
            for j, bj in enumerate(cb):
                prod[i + j] = (prod[i + j] + ai * bj) % p
    # reduce: x^m = -red
    for d in range(2 * m - 2, m - 1, -1):
        c = prod[d]
        if c:
            prod[d] = 0
            for i in range(m):
                prod[d - m + i] = (prod[d - m + i] - c * red[i]) % p
    return sum(prod[i] * p**i for i in range(m))


def _find_irreducible(p: int, m: int) -> tuple:
    """Monic irreducible polynomial of degree m over GF(p), returned as the
    m low-order coefficients (x^m coefficient implicit 1).  Exhaustive search
    with an irreducibility test by checking it has no roots in any proper
    subfield extension — implemented via the standard 'x^(p^m) == x and
    gcd conditions' shortcut replaced, for tiny m, by brute-force trial
    division over all monic factors of degree <= m//2."""
    def poly_from_int(n, deg):
        return [(n // p**i) % p for i in range(deg + 1)]

    def poly_mod(num, den, pmod):
        num = num[:]
        dd = len(den) - 1
        while len(num) - 1 >= dd and any(num):
            if num[-1] == 0:
                num.pop()
                continue
            shift = len(num) - 1 - dd
            factor = (num[-1] * pow(den[-1], -1, pmod)) % pmod
            for i, d in enumerate(den):
                num[shift + i] = (num[shift + i] - factor * d) % pmod
            while num and num[-1] == 0:
                num.pop()
        return num

    for n in range(p**m, 2 * p**m):
        cand = poly_from_int(n, m)  # monic degree-m (n in [p^m, 2p^m) => top digit 1)
        if cand[-1] != 1:
            continue
        irreducible = True
        for d in range(1, m // 2 + 1):
            for fn in range(p**d, 2 * p**d):
                f = poly_from_int(fn, d)
                if f[-1] != 1:
                    continue
                if not poly_mod(cand, f, p):
                    irreducible = False
                    break
            if not irreducible:
                break
        if irreducible:
            return tuple(cand[:m])
    raise RuntimeError(f"no irreducible polynomial found for GF({p}^{m})")


class GF:
    """Finite field GF(q).  Cached per q; exposes dense numpy op tables."""

    _cache: dict = {}

    def __new__(cls, q: int):
        if q in cls._cache:
            return cls._cache[q]
        inst = super().__new__(cls)
        cls._cache[q] = inst
        return inst

    def __init__(self, q: int):
        if hasattr(self, "q"):  # cached instance, already initialised
            return
        pp = factor_prime_power(q)
        if pp is None:
            raise ValueError(f"q={q} is not a prime power")
        self.q = q
        self.p, self.m = pp
        if self.m == 1:
            idx = np.arange(q, dtype=np.int64)
            self.add_table = (idx[:, None] + idx[None, :]) % q
            self.sub_table = (idx[:, None] - idx[None, :]) % q
            self.mul_table = (idx[:, None] * idx[None, :]) % q
            self.neg_table = (-idx) % q
        else:
            p, m = self.p, self.m
            red = _find_irreducible(p, m)
            self._red = red
            idx = np.arange(q, dtype=np.int64)
            # addition: digitwise mod-p add of base-p representations
            digits = np.stack([(idx // p**i) % p for i in range(m)], axis=1)
            weights = np.array([p**i for i in range(m)], dtype=np.int64)
            dsum = (digits[:, None, :] + digits[None, :, :]) % p
            self.add_table = (dsum * weights).sum(axis=2)
            dneg = (-digits) % p
            self.neg_table = (dneg * weights).sum(axis=1)
            self.sub_table = self.add_table[:, self.neg_table]
            mul = np.zeros((q, q), dtype=np.int64)
            for a in range(q):
                for b in range(a, q):
                    v = _poly_mul_mod(a, b, p, m, red)
                    mul[a, b] = v
                    mul[b, a] = v
            self.mul_table = mul
        self.xi = self._find_primitive()

    # -- scalar ops -------------------------------------------------------
    def add(self, a, b):
        return self.add_table[a, b]

    def sub(self, a, b):
        return self.sub_table[a, b]

    def mul(self, a, b):
        return self.mul_table[a, b]

    def neg(self, a):
        return self.neg_table[a]

    def pow(self, a: int, e: int) -> int:
        r = 1
        for _ in range(e):
            r = int(self.mul_table[r, a])
        return r

    def _find_primitive(self) -> int:
        """Smallest primitive element xi (multiplicative order q-1).
        Exhaustive search — the strategy the paper itself uses (§II-B1a)."""
        if self.q == 2:
            return 1
        target = self.q - 1
        for cand in range(2, self.q):
            seen = set()
            v = 1
            for _ in range(target):
                v = int(self.mul_table[v, cand])
                if v in seen:
                    break
                seen.add(v)
            if len(seen) == target:
                return cand
        raise RuntimeError(f"no primitive element in GF({self.q})")

    def powers(self, base: int, n: int) -> list:
        """[base^0, base^1, ..., base^{n-1}]"""
        out, v = [], 1
        for _ in range(n):
            out.append(v)
            v = int(self.mul_table[v, base])
        return out
