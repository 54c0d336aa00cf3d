"""Token ids for every run, drawn from (seed, index) with numpy.

`zipf_tokens` is a frozen copy of the program's synthetic pipeline
(`repro_torch/data/pipeline.py::_zipf_tokens`): Zipf-distributed ids in
[0, vocab), a heavy head and a long tail, as text has.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rng_for", "zipf_tokens"]


def rng_for(seed: int, *index: int) -> np.random.Generator:
    """A generator that depends on (seed, index...) alone."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, index)]))


def zipf_tokens(rng: np.random.Generator, shape, vocab: int, alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids in [0, vocab) (heavy head, long tail)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(vocab, size=shape, p=probs).astype(np.int32)
