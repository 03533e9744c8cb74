"""The one traffic generator: a closed loop of clients over a mix file.

A mix (``traffic/<name>.json``) gives the number of clients, the prompt and
output length distributions and how the loop starts. Requests come in
blocks of ``block``: block k holds one prompt length from each of ``block``
equal-probability strata of the prompt distribution and one output length
from each stratum of the output distribution, at a point inside each
stratum that depends on k alone. So every seed serves the same lengths in
every block, and any window holds the same mix up to one partial block. The
seed only pairs and orders them within each block, draws the prompt tokens
and orders the steady-state offsets of the first requests.

``start: "steady"``: each client's first request stands for one already
under way: its prompt is its own prompt plus ``k`` tokens, ``k`` below its
output length, and only the rest is left to generate. Set-up prefills those
caches, so the window opens with fills spread as they are mid-stream."""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

_MASK = 2**63 - 1
_PHI = 0.6180339887498949            # where block k samples inside a stratum
_SQRT2 = 0.41421356237309515


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """Lengths at probabilities ``u`` of ``dist``, rounded and clipped to
    [min, max]."""
    u = np.asarray(u, dtype=float)
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u.ravel()])
        x = dist["median"] * np.exp(dist["sigma"] * z.reshape(u.shape))
    elif dist["dist"] == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def block_lengths(mix: dict, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, output lengths) of block ``k``, one per stratum in
    stratum order: the same for every seed."""
    n = mix["block"]
    strata = np.arange(n)
    up = (strata + ((k + 0.5) * _PHI) % 1.0) / n
    uo = (strata + ((k + 0.5) * _SQRT2) % 1.0) / n
    return quantile(mix["prompt"], up), quantile(mix["output"], uo)


@dataclass
class Request:
    index: int              # position in the mix's stream of requests
    prompt: list            # token ids
    max_new_tokens: int
    steady_offset: int      # tokens of a steady-state start folded into
                            # the prompt (0 for every later request)


class Traffic:
    """The stream of requests of ``mix`` over ``vocab`` token ids, from
    ``seed``. ``take()`` gives the next request in send order."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"traffic {mix['name']}: only closed loops")
        if mix.get("sampling") != "greedy":
            raise ValueError(f"traffic {mix['name']}: only greedy requests")
        self.mix, self.vocab = mix, vocab
        self.seed = seed & _MASK
        self.clients = mix["clients"]
        self._rng = np.random.default_rng([self.seed, 0])
        self._shapes: list[tuple[int, int]] = []
        self._next = 0
        n = self.clients
        fracs = (np.arange(n) + 0.5) / n
        self._steady = (fracs[self._rng.permutation(n)]
                        if mix.get("start") == "steady" else np.zeros(n))

    def _shape(self, j: int) -> tuple[int, int]:
        while j >= len(self._shapes):
            k = len(self._shapes) // self.mix["block"]
            prompts, outputs = block_lengths(self.mix, k)
            pi = self._rng.permutation(len(prompts))
            sigma = self._rng.permutation(len(outputs))
            self._shapes.extend((int(prompts[a]), int(outputs[b]))
                                for a, b in zip(pi, sigma))
        return self._shapes[j]

    def take(self) -> Request:
        j = self._next
        self._next += 1
        p, o = self._shape(j)
        k = int(self._steady[j] * o) if j < self.clients else 0
        k = min(k, o - 1)
        toks = np.random.default_rng([self.seed, 1, j]).integers(
            0, self.vocab, p + k)
        return Request(j, toks.tolist(), o - k, k)
