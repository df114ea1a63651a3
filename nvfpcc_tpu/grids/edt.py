"""Exact integer Euclidean distance transform on device.

Replaces the reference's per-voxel KD-tree nearest-neighbor queries
(``util_get_grids.py:32-41``: ~30M queries on host) with a separable squared
EDT over the cloud's bounding grid, computed on the device in int32:

    d2(x,y,z) = min_p ||(x,y,z) - p||^2
              = 1-D min-plus transforms applied along z, then y, then x,
                starting from 0/INF occupancy.

Each 1-D pass computes ``out[i] = min_j f[j] + (i-j)^2``. Because every leaf
block contains at least one point, any block voxel's true distance is at most
the block diagonal (31*sqrt(3) ~ 53.7 for 32^3 blocks), so the search window
can be clamped to a radius R >= ceil(diag): values above R^2 are saturated and
never on an optimal path, keeping the clamped transform *exact* for all block
voxels. The windowed pass is a min over 2R+1 shifted slices of one operand —
pure elementwise work that XLA fuses into one loop per pass, no gathers, no
data-dependent control flow.

Squared distances of integer grids are integers, so results match the
reference's KD-tree distances bit-for-bit after ``sqrt`` in float32
(golden-tested against brute force).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.int32(2**30)


def _minplus_pass_1d(f: jnp.ndarray, radius: int, cap: int) -> jnp.ndarray:
    """Windowed min-plus parabola transform along the last axis.

    ``out[..., i] = min(cap, min_{|d|<=R} f[..., i+d] + d^2)`` with edge
    padding at ``cap``.
    """
    f = jnp.minimum(f, cap)
    L = f.shape[-1]
    padded = jnp.pad(f, [(0, 0)] * (f.ndim - 1) + [(radius, radius)], constant_values=cap)
    out = f  # d = 0 term
    for d in range(1, radius + 1):
        d2 = jnp.int32(d * d)
        left = jax.lax.slice_in_dim(padded, radius - d, radius - d + L, axis=f.ndim - 1)
        right = jax.lax.slice_in_dim(padded, radius + d, radius + d + L, axis=f.ndim - 1)
        out = jnp.minimum(out, jnp.minimum(left, right) + d2)
    return jnp.minimum(out, cap)


@partial(jax.jit, static_argnames=("radius",))
def squared_edt_3d(occ: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Exact (window-clamped) squared EDT of a 3-D occupancy grid.

    ``occ`` is (D, H, W) bool/int; returns int32 squared distances, saturated
    at ``radius^2 + 1`` (exact wherever the true distance <= radius).

    Runs wherever its input lives: the grids builder and the D1 metric
    place it on the ambient device, or on the host for ``platform="cpu"``.
    The grids builder additionally probe-checks its output against brute
    force (:func:`nvfpcc_tpu.grids.builder.validate_dist_grids`).
    """
    cap = jnp.int32(radius * radius + 1)
    f = jnp.where(occ.astype(bool), jnp.int32(0), cap)
    # pass along W (last axis)
    f = _minplus_pass_1d(f, radius, cap)
    # pass along H
    f = jnp.swapaxes(_minplus_pass_1d(jnp.swapaxes(f, 1, 2), radius, cap), 1, 2)
    # pass along D
    f = jnp.swapaxes(_minplus_pass_1d(jnp.swapaxes(f, 0, 2), radius, cap), 0, 2)
    return f


def brute_force_sq_dist(voxels: np.ndarray, points: np.ndarray) -> np.ndarray:
    """O(V*P) integer reference for tests: min squared distance per voxel."""
    v = np.asarray(voxels, dtype=np.int64)[:, None, :]
    p = np.asarray(points, dtype=np.int64)[None, :, :]
    return np.square(v - p).sum(-1).min(1)
