"""Point-to-point (D1) PSNR between voxelized clouds.

The reference only reports a training-time proxy (PSNR1 from the
ground-truth distance grids over predicted-occupied voxels,
``NVFPCC.py:259-260``). This is the real MPEG-style D1 metric: symmetric
nearest-neighbor mean-squared distance between the two point sets,

    mse(A->B) = mean_a min_b ||a - b||^2
    D1 PSNR   = 10 * log10(3 * (2^depth - 1)^2 / max(mse(A->B), mse(B->A)))

computed exactly for integer voxel clouds with the same windowed separable
EDT used by the grid builder (``nvfpcc_tpu.grids.edt``) — no KD-tree, one
jitted program per direction.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from nvfpcc_tpu.grids.edt import squared_edt_3d

_ALIGN = 8


def _nn_sq_dists(
    from_pts: np.ndarray, to_pts: np.ndarray, radius: int, platform: str | None
) -> np.ndarray:
    """Exact squared NN distance from each of ``from_pts`` to the set
    ``to_pts`` (saturated at radius^2 + 1)."""
    lo = np.minimum(from_pts.min(0), to_pts.min(0)) - 1
    hi = np.maximum(from_pts.max(0), to_pts.max(0)) + 2
    dims = tuple(int(d) for d in ((hi - lo + radius * 2 + _ALIGN - 1) // _ALIGN) * _ALIGN)

    def run():
        occ = jnp.zeros(dims, jnp.bool_)
        rel_to = jnp.asarray(to_pts - lo + radius, jnp.int32)
        occ = occ.at[rel_to[:, 0], rel_to[:, 1], rel_to[:, 2]].set(True)
        sq = squared_edt_3d(occ, radius)
        rel_from = jnp.asarray(from_pts - lo + radius, jnp.int32)
        return sq[rel_from[:, 0], rel_from[:, 1], rel_from[:, 2]]

    if platform is None:
        out = run()
    else:
        with jax.default_device(jax.local_devices(backend=platform)[0]):
            out = run()
    return np.asarray(out, np.int64)


def d1_psnr(
    ref_pts: np.ndarray,
    rec_pts: np.ndarray,
    depth: int = 10,
    radius: int = 63,
    platform: str | None = None,
) -> dict:
    """Symmetric D1 metrics between integer voxel clouds.

    Returns {"mse_ab", "mse_ba", "mse", "psnr"} with peak = 2^depth - 1.
    Distances saturate at ``radius`` (fine unless the reconstruction is
    pathologically far from the source). ``platform``: ``None`` (default)
    runs the EDT on the ambient device, ``"cpu"`` on the host.
    """
    a = np.asarray(ref_pts, np.int64)
    b = np.asarray(rec_pts, np.int64)
    if len(a) == 0 or len(b) == 0:
        return {"mse_ab": math.inf, "mse_ba": math.inf, "mse": math.inf, "psnr": -math.inf}
    mse_ab = float(_nn_sq_dists(a, b, radius, platform).mean())
    mse_ba = float(_nn_sq_dists(b, a, radius, platform).mean())
    mse = max(mse_ab, mse_ba)
    peak = (1 << depth) - 1
    psnr = 10.0 * math.log10(3.0 * peak * peak / mse) if mse > 0 else math.inf
    return {"mse_ab": mse_ab, "mse_ba": mse_ba, "mse": mse, "psnr": psnr}
