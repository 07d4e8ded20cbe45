"""The JAX package's initial weights from an integer seed, in numpy.

The JAX package draws a model's weights from ``jax.random.PRNGKey(seed)``
(threefry2x32, with ``jax_threefry_partitionable``, the default since JAX
0.5); the port draws its own from a ``torch.Generator``.  The two draws
come from one distribution, but the TPU probes' gates were met from one
particular draw: ``probe_windowcut.py``'s AUC 0.995 and
``probe_doublets.py``'s 0.93 were recorded from ``PRNGKey(0)``.  This
module reproduces that draw bit for bit without JAX: the threefry2x32
hash, ``split``, 32-bit ``random_bits`` and ``uniform`` in f32, and on
them the SegmentClassifier's parameter tree as
``gnn_fpga_tpu/models/mpnn.py::init_segment_classifier`` builds it
(``utils/serialization.py::load_jax_params`` copies it into a model).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotate_left(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counts ``(x0, x1)``
    (uint32 arrays of one shape) under ``key`` (two uint32 words)."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotate_left(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words, for ``0 <= seed < 2^32``."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return np.array([0, seed], np.uint32)


def _counts(shape) -> tuple:
    """A 64-bit iota over ``shape`` as its high and low uint32 words."""
    n = int(np.prod(shape, dtype=np.int64))
    lo = np.arange(n, dtype=np.uint64)
    return ((lo >> np.uint64(32)).astype(np.uint32).reshape(shape),
            (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape))


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: ``[n, 2]`` keys."""
    b0, b1 = threefry2x32(key, *_counts((n,)))
    return np.stack([b0, b1], axis=-1)


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    b0, b1 = threefry2x32(key, *_counts(tuple(shape)))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # floats * (hi - lo) + lo rounded once, as XLA's fused multiply-add
    # does: floats is k 2^-23 (k < 2^23), so in f64 the product and the
    # sum are exact and the one rounding is the cast to f32
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def _linear(key, in_dim: int, out_dim: int) -> dict:
    """``_init_linear``: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    kw, kb = split(key)
    bound = np.float32(1.0) / np.sqrt(np.float32(in_dim))
    return {"w": uniform(kw, (in_dim, out_dim), -bound, bound),
            "b": uniform(kb, (out_dim,), -bound, bound)}


def segment_classifier_params(seed: int, input_dim: int,
                              hidden_dim: int) -> dict:
    """The JAX package's ``init_segment_classifier(PRNGKey(seed), cfg)``
    tree (shared weights, f32) for ``input_dim`` and ``hidden_dim``."""
    k_in, k_e, k_n = split(prng_key(seed), 3)
    d = input_dim + hidden_dim
    ke1, ke2 = split(k_e)
    kn1, kn2 = split(k_n)
    return {"input": _linear(k_in, input_dim, hidden_dim),
            "edge": {"l1": _linear(ke1, 2 * d, hidden_dim),
                     "l2": _linear(ke2, hidden_dim, 1)},
            "node": {"l1": _linear(kn1, 3 * d, hidden_dim),
                     "l2": _linear(kn2, hidden_dim, hidden_dim)}}
