"""Seeding and a counter-based stream of ``torch.Generator``s (port of the
JAX package's ``utils/prng.py``).

Library code takes explicit generators; ``KeyStream`` hands them out for
host-side code (dropout streams, shuffling)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _mix(seed: int, counter: int) -> int:
    """splitmix64 of (seed, counter): neighbouring counters give unrelated
    63-bit generator seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + (counter + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def set_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs (python, numpy, PYTHONHASHSEED) and return the
    root CPU generator. torch's global generators are left alone: library
    code draws from explicit generators only."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(int(seed))


class KeyStream:
    """A counter-based stream of generators.

    The i-th generator is seeded from ``(seed, i)`` alone, so the stream is
    stateless given (seed, counter): a preempted run restores the exact
    stream position in O(1) by persisting the counter in its checkpoint.
    The draws differ from the JAX package's; the position rule is the same.

    >>> ks = KeyStream(42)
    >>> g1 = ks.next()   # a fresh generator each call
    >>> g2 = ks.next()
    """

    def __init__(self, seed: int, counter: int = 0, device="cpu"):
        self.seed = int(seed)
        self.counter = int(counter)
        self.device = device

    def next(self) -> torch.Generator:
        gen = torch.Generator(device=self.device).manual_seed(_mix(self.seed, self.counter))
        self.counter += 1
        return gen

    def split(self, n: int):
        return [self.next() for _ in range(n)]
