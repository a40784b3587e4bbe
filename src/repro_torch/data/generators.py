"""Dataset generators mirroring the paper's evaluation data.

Kept in numpy, bit-for-bit the generators of the JAX package, so the
tests can feed both packages the same inputs.  The paper uses:
  * Synthetic — random walk, 100M series x 256 points
    (x_{t+1} = x_t + N(0,1));
  * SALD      — electroencephalography, 200M x 128;
  * Seismic   — seismic activity records, 100M x 256.
The two real datasets are not redistributable; the surrogates match
their signal character.
"""
from __future__ import annotations

import numpy as np


def random_walk(n_series: int, length: int = 256, *, seed: int = 0,
                chunk: int = 1 << 16) -> np.ndarray:
    """The paper's Synthetic generator: cumulative sum of N(0,1) steps."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_series, length), np.float32)
    for i in range(0, n_series, chunk):
        j = min(i + chunk, n_series)
        steps = rng.standard_normal((j - i, length), dtype=np.float32)
        np.cumsum(steps, axis=1, out=out[i:j])
    return out


def sald_like(n_series: int, length: int = 128, *, seed: int = 1) -> np.ndarray:
    """EEG-like surrogate: mixture of alpha/beta/theta band oscillations +
    1/f noise. Matches SALD's 128-point series length."""
    rng = np.random.default_rng(seed)
    t = np.arange(length, dtype=np.float32)
    out = np.zeros((n_series, length), np.float32)
    for band_hz, amp in ((0.04, 1.0), (0.09, 0.7), (0.17, 0.4)):
        f = band_hz * (1.0 + 0.3 * rng.standard_normal((n_series, 1)))
        ph = rng.uniform(0, 2 * np.pi, (n_series, 1))
        a = amp * (0.5 + rng.random((n_series, 1)))
        out += (a * np.sin(2 * np.pi * f * t[None, :] + ph)).astype(np.float32)
    out += 0.35 * np.cumsum(
        rng.standard_normal((n_series, length), dtype=np.float32), axis=1) \
        / np.sqrt(length)
    return out


def seismic_like(n_series: int, length: int = 256, *, seed: int = 2) -> np.ndarray:
    """Seismic-like surrogate: quiet background + occasional decaying bursts."""
    rng = np.random.default_rng(seed)
    t = np.arange(length, dtype=np.float32)
    noise = 0.1 * rng.standard_normal((n_series, length)).astype(np.float32)
    onset = rng.integers(0, length, (n_series, 1))
    decay = np.exp(-np.maximum(t[None, :] - onset, 0) / (length / 8)) \
        * (t[None, :] >= onset)
    carrier = np.sin(2 * np.pi * 0.12 * t)[None, :] \
        + 0.5 * np.sin(2 * np.pi * 0.31 * t + 1.3)[None, :]
    amp = rng.gamma(2.0, 1.0, (n_series, 1)).astype(np.float32)
    return (noise + amp * decay * carrier).astype(np.float32)


_GENERATORS = {
    "synthetic": random_walk,
    "sald": sald_like,
    "seismic": seismic_like,
}

# The paper's full-scale dataset shapes.
PAPER_SCALES = {
    "synthetic": (100_000_000, 256),
    "sald": (200_000_000, 128),
    "seismic": (100_000_000, 256),
}


def make_dataset(name: str, n_series: int, length: int | None = None,
                 seed: int | None = None) -> np.ndarray:
    gen = _GENERATORS[name]
    kw = {}
    if length is not None:
        kw["length"] = length
    if seed is not None:
        kw["seed"] = seed
    return gen(n_series, **kw)
