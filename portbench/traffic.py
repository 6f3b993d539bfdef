"""The one traffic generator: NumPy, driven by a mix's data file and the seed.

Every seed gets the same work.  A size or a gap is drawn as a stratified
sample: each block of ``BLOCK`` consecutive draws holds the distribution's
``BLOCK`` quantiles at ``(i + 0.5) / BLOCK`` once each, the blocks' orders
drawn from one generator that no seed changes.  So a mix is one fixed trace:
every seed sends the same sizes at the same times, and a tail over a few
dozen requests is measured over that one trace.  The seed draws what the
requests carry: token ids, uniform over the vocabulary, and which images.

Distributions, as a mix file writes them: ``{"dist": "loguniform", "lo":
256, "hi": 2048}`` (integers), ``{"dist": "uniform", "lo": 32, "hi": 128}``
(integers, both ends included), ``{"dist": "const", "value": 16}``, and for
gaps ``{"dist": "exponential", "rate": 6.5}`` (seconds).  Due times are in
seconds from the window's start.
"""
from __future__ import annotations

import math

import numpy as np

from portbench.reference.draw import sub_seed

__all__ = ["BLOCK", "rng", "quantile", "stratified", "lm_requests", "arrivals",
           "image_order"]

BLOCK = 32


def rng(seed: int, key: str) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(sub_seed(seed, key)))


def quantile(dist: dict, q: float) -> float:
    kind = dist["dist"]
    if kind == "const":
        return dist["value"]
    if kind == "loguniform":
        lo, hi = dist["lo"], dist["hi"]
        return int(round(lo * (hi / lo) ** q))
    if kind == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        return min(hi, lo + int(q * (hi - lo + 1)))
    if kind == "exponential":
        return -math.log1p(-q) / dist["rate"]
    raise ValueError(f"unknown distribution {kind!r}")


def stratified(dist: dict, n: int, g: np.random.Generator) -> list:
    """``n`` draws of ``dist``: whole blocks of its quantiles, each block in
    its own order."""
    levels = [quantile(dist, (i + 0.5) / BLOCK) for i in range(BLOCK)]
    out = []
    while len(out) < n:
        out.extend(levels[i] for i in g.permutation(BLOCK))
    return out[:n]


def lm_requests(mix: dict, seed: int, n: int, vocab: int) -> list:
    """``n`` requests ``(prompt int32 ids, max_new)`` of an LM mix: the
    sizes the same for every seed, the ids the seed's."""
    g = rng(0, "lm_sizes")
    lens = stratified(mix["prompt_len"], n, g)
    outs = stratified(mix["output_len"], n, g)
    ids = rng(seed, "lm_ids")
    return [(ids.integers(0, vocab, size=int(s), dtype=np.int32), int(o))
            for s, o in zip(lens, outs)]


def arrivals(mix: dict, seconds: float) -> np.ndarray:
    """Due times in ``[0, seconds)`` of an open loop: cumulative stratified
    gaps of ``mix["gap"]``, the same for every seed."""
    g = rng(0, "arrivals")
    mean = quantile(mix["gap"], 0.5) / math.log(2.0)
    n = int(seconds / mean * 1.5) + 2 * BLOCK
    t = np.cumsum(stratified(mix["gap"], n, g))
    return t[t < seconds]


def image_order(seed: int, pool: int, n: int) -> np.ndarray:
    """Which of the ``pool`` images each of ``n`` sends carries: the pool
    over and over, each pass in its own order."""
    g = rng(seed, "image_order")
    reps = -(-n // pool)
    return np.concatenate([g.permutation(pool) for _ in range(reps)])[:n]
