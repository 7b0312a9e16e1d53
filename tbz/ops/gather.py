"""Clipped gather shared by the device kernels.

``take(x, idx) == x[clip(idx, 0, len(x) - 1)]`` along axis 0: element
gathers on 1D `x`, row gathers on 2D `x`. Clipping pins what an index
past either end reads (XLA leaves it implementation-defined); callers
mask such lanes themselves.
"""

from __future__ import annotations

import jax.numpy as jnp


def take(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    return x[jnp.clip(idx, 0, x.shape[0] - 1)]
