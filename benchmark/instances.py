"""Seeded SIPP instances whose discrete logarithms the benchmark knows.

A walk is n points [a_i] G (G1 or G2), made on the host in plain arithmetic
(benchmark/reference/bn254.py): each point is one affine addition of a seeded
step point to the one before it (a random walk over 16 steps [d_j] G), so
the logarithms are known without a scalar multiplication a point.  A pool
holds w walks in G1 and w in G2.  Instance (p, q, c, k), for c odd below n
and k below n, pairs G1 walk p with G2 walk q permuted by i -> c i + k mod
n: w^2 n^2 / 2 distinct instances, w the least that holds the draws a run
may take.  The j-th draw of a run is instance (s j + o) mod size, s coprime
to the size and o drawn from the seed: the draws are made lazily and repeat
only past the pool's size; the harness counts any repeat as a fault.
Points are written in the program's layout: (n, 2, 16) and (n, 2, 2, 16)
16-bit Montgomery limbs.
"""

import math
import random

import numpy as np

from .reference import bn254

STEPS = 16


def _walk(rng, n, start, steps, add):
    """(points, logs) of a seeded walk from [start] G: each point the last
    plus one of the (step point, step log) pairs."""
    pts, logs = [start[0]], [start[1]]
    for _ in range(n - 1):
        pt, log = steps[rng.randrange(STEPS)]
        pts.append(add(pts[-1], pt))
        logs.append((logs[-1] + log) % bn254.R)
        if pts[-1] is None:
            raise ValueError("the walk met the point at infinity")
    return pts, logs


def _limbs(values, shape):
    """Canonical ints -> int64 Montgomery limbs of `shape` + (16,)."""
    raw = b"".join((v * bn254.MONT % bn254.P).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").astype(np.int64).reshape(*shape, 16)


class Pool:
    def __init__(self, n, draws, seed):
        """A pool of at least `draws` distinct instances of n pairs."""
        if n < 2 or n & (n - 1):
            raise ValueError(f"n must be a power of two, at least 2: {n}")
        self.n, self.per_combo = n, n * n // 2
        self.walks = math.isqrt(-(-max(draws, 1) // self.per_combo) - 1) + 1
        self.size = self.walks ** 2 * self.per_combo
        rng = random.Random(seed)

        def seeded(mul, gen):
            k = rng.randrange(1, bn254.R)
            return mul(gen, k), k

        g1_steps = [seeded(bn254.g1_mul, bn254.G1_GEN) for _ in range(STEPS)]
        g2_steps = [seeded(bn254.g2_mul, bn254.G2_GEN) for _ in range(STEPS)]
        self.a_pts, self.a_logs, self.b_pts, self.b_logs = [], [], [], []
        for _ in range(self.walks):
            pts, logs = _walk(rng, n, seeded(bn254.g1_mul, bn254.G1_GEN), g1_steps,
                              bn254.g1_add)
            self.a_pts.append(pts)
            self.a_logs.append(logs)
            pts, logs = _walk(rng, n, seeded(bn254.g2_mul, bn254.G2_GEN), g2_steps,
                              bn254.g2_add)
            self.b_pts.append(pts)
            self.b_logs.append(logs)
        self.step = rng.randrange(1, self.size) | 1
        while math.gcd(self.step, self.size) != 1:
            self.step += 2
        self.offset = rng.randrange(self.size)

    def draw(self, j):
        """The j-th instance of a run, as (p, q, c, k)."""
        return self.instance((self.step * j + self.offset) % self.size)

    def instance(self, t):
        """The t-th instance of all the pool holds, as (p, q, c, k)."""
        p, rest = divmod(t, self.walks * self.per_combo)
        q, rest = divmod(rest, self.per_combo)
        return p, q, 2 * (rest // self.n) + 1, rest % self.n

    def perm(self, inst):
        c, k = inst[2:]
        return [(c * i + k) % self.n for i in range(self.n)]

    def points(self, inst):
        """The instance's host points (A, B) in order."""
        b = self.b_pts[inst[1]]
        return self.a_pts[inst[0]], [b[j] for j in self.perm(inst)]

    def logs(self, inst):
        b = self.b_logs[inst[1]]
        return self.a_logs[inst[0]], [b[j] for j in self.perm(inst)]

    def limbs(self):
        """The walks' points: (w, n, 2, 16) and (w, n, 2, 2, 16) int64 arrays."""
        a = [v for pts in self.a_pts for pt in pts for v in pt]
        b = [v for pts in self.b_pts for pt in pts for c in pt for v in c]
        return (_limbs(a, (self.walks, self.n, 2)),
                _limbs(b, (self.walks, self.n, 2, 2)))


def repeats(instances):
    """How many of the instances repeat one before them."""
    return len(instances) - len(set(instances))
