"""Point-to-plane (D2) PSNR between voxelized clouds.

The reference computes neither D1 nor D2 itself — it reports the PSNR1
training proxy (``NVFPCC.py:259-260``) and leaves real metrics to external
MPEG tooling (``README.md`` workflow); the driver's BASELINE.json names
"bpp + D1/D2 PSNR" as the metric set. This implements the MPEG-style
point-to-plane metric (Tian et al., "Geometric distortion metrics for point
cloud compression", ICIP 2017): the error vector from each point to its
exact nearest neighbor in the other cloud is projected onto the estimated
surface normal AT that nearest neighbor, so tangential drift along the
surface is not penalized:

    e(a->B)   = a - nn_B(a)
    mse(A->B) = mean_a ( e(a->B) . n(nn_B(a)) )^2
    D2 PSNR   = 10 log10( 3 (2^depth-1)^2 / max(mse(A->B), mse(B->A)) )

Normals are estimated per occupied voxel by PCA over the occupied voxels in
a Chebyshev-radius window (smallest-eigenvalue eigenvector of the
neighborhood covariance) — the standard treatment for voxelized surfaces.
A point whose neighborhood is too degenerate for a plane fit (< 3 occupied
neighbors) keeps its FULL Euclidean error (its D1 contribution) instead of
silently contributing zero, so degenerate normals can only raise the
reported error, never hide it.

Everything is exact integer host math except the nearest-neighbor distance
field, which reuses the same jitted windowed EDT as the D1 metric
(:mod:`nvfpcc_tpu.metrics.d1`); the NN *vector* is then recovered exactly by
matching each point's EDT squared distance against the finite set of
integer offsets with that squared norm (ties broken deterministically by
offset enumeration order — any tied neighbor is a valid NN).
"""

from __future__ import annotations

import math

import numpy as np

from nvfpcc_tpu.metrics.d1 import _nn_sq_dists

_BITS = 21  # per-axis key width: coords (after shift) must be < 2^21


def _keys(pts: np.ndarray) -> np.ndarray:
    """Collision-free int64 key per integer coordinate triple (nonneg)."""
    if pts.size and int(pts.max()) >= (1 << _BITS):
        raise ValueError("coordinates too large for key packing")
    return (pts[:, 0] << (2 * _BITS)) | (pts[:, 1] << _BITS) | pts[:, 2]


def estimate_normals(pts: np.ndarray, radius: int = 2):
    """Unit normals per point via windowed PCA over the occupied voxels
    within Chebyshev ``radius``.

    Returns ``(normals (N,3) float64, valid (N,) bool)``; ``valid`` is False
    where fewer than 3 occupied voxels (including the point itself) fall in
    the window, i.e. no plane is defined. Normal SIGN is arbitrary (D2 only
    uses the squared projection).
    """
    pts = np.asarray(pts, np.int64)
    n = len(pts)
    if n == 0:
        return np.zeros((0, 3)), np.zeros((0,), bool)
    lo = pts.min(0)
    sh = pts - lo + radius  # nonneg, window stays nonneg
    skeys = _keys(sh)
    order = np.argsort(skeys, kind="stable")
    skeys_sorted = skeys[order]

    cnt = np.zeros(n, np.int64)
    s = np.zeros((n, 3), np.float64)
    # symmetric second moments: xx, yy, zz, xy, xz, yz
    ss = np.zeros((n, 6), np.float64)
    r = int(radius)
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                d = np.array([dz, dy, dx], np.int64)
                q = sh + d
                qk = _keys(q)
                idx = np.searchsorted(skeys_sorted, qk)
                idx_c = np.minimum(idx, n - 1)
                present = skeys_sorted[idx_c] == qk
                qf = q.astype(np.float64)
                m = present.astype(np.float64)
                cnt += present
                s += m[:, None] * qf
                ss[:, 0] += m * qf[:, 0] * qf[:, 0]
                ss[:, 1] += m * qf[:, 1] * qf[:, 1]
                ss[:, 2] += m * qf[:, 2] * qf[:, 2]
                ss[:, 3] += m * qf[:, 0] * qf[:, 1]
                ss[:, 4] += m * qf[:, 0] * qf[:, 2]
                ss[:, 5] += m * qf[:, 1] * qf[:, 2]

    c = np.maximum(cnt, 1).astype(np.float64)
    mean = s / c[:, None]
    cov = np.empty((n, 3, 3), np.float64)
    cov[:, 0, 0] = ss[:, 0] / c - mean[:, 0] * mean[:, 0]
    cov[:, 1, 1] = ss[:, 1] / c - mean[:, 1] * mean[:, 1]
    cov[:, 2, 2] = ss[:, 2] / c - mean[:, 2] * mean[:, 2]
    cov[:, 0, 1] = cov[:, 1, 0] = ss[:, 3] / c - mean[:, 0] * mean[:, 1]
    cov[:, 0, 2] = cov[:, 2, 0] = ss[:, 4] / c - mean[:, 0] * mean[:, 2]
    cov[:, 1, 2] = cov[:, 2, 1] = ss[:, 5] / c - mean[:, 1] * mean[:, 2]
    # eigh returns eigenvalues ascending: column 0 = smallest = plane normal
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]
    valid = cnt >= 3
    return normals, valid


def _sphere_offsets(v: int, rmax: int):
    """All integer (dz,dy,dx) with dz^2+dy^2+dx^2 == v (|.| <= rmax)."""
    out = []
    zmax = min(rmax, math.isqrt(v))
    for dz in range(-zmax, zmax + 1):
        rem_z = v - dz * dz
        ymax = min(rmax, math.isqrt(rem_z))
        for dy in range(-ymax, ymax + 1):
            rem = rem_z - dy * dy
            dx = math.isqrt(rem)
            if dx * dx == rem:
                if dx == 0:
                    out.append((dz, dy, 0))
                else:
                    out.append((dz, dy, dx))
                    out.append((dz, dy, -dx))
    return out


def nn_vectors(
    from_pts: np.ndarray,
    to_pts: np.ndarray,
    radius: int = 63,
    platform: str | None = None,
):
    """Exact nearest-neighbor vectors ``e`` and indices ``j`` such that
    ``to_pts[j]`` is a nearest neighbor of each ``from_pts`` row and
    ``e = to_pts[j] - from_pts`` with ``|e|`` minimal.

    The squared distances come from the shared windowed EDT; the vector is
    recovered by testing, per distinct squared distance, exactly the integer
    offsets of that norm for membership in ``to_pts``.
    """
    a = np.asarray(from_pts, np.int64)
    b = np.asarray(to_pts, np.int64)
    d2 = _nn_sq_dists(a, b, radius, platform)
    if int(d2.max(initial=0)) > radius * radius:
        raise ValueError(
            f"NN distance exceeds the EDT window (radius {radius}); "
            "the clouds are too far apart for an exact D2"
        )
    n = len(a)
    nb = len(b)
    bkeys = _keys(b - 0)  # b must be nonneg voxel coords
    border = np.argsort(bkeys, kind="stable")
    bkeys_sorted = bkeys[border]

    e = np.zeros((n, 3), np.int64)
    j = np.full(n, -1, np.int64)
    # d2 == 0: the point itself is in b
    zero = np.where(d2 == 0)[0]
    if len(zero):
        idx = np.searchsorted(bkeys_sorted, _keys(a[zero]))
        j[zero] = border[np.minimum(idx, nb - 1)]
    rmax = math.isqrt(int(d2.max(initial=0)))
    for v in np.unique(d2[d2 > 0]):
        v = int(v)
        rows = np.where(d2 == v)[0]
        for off in _sphere_offsets(v, rmax):
            if not len(rows):
                break
            d = np.array(off, np.int64)
            q = a[rows] + d
            if (q < 0).any():
                ok = (q >= 0).all(1)
            else:
                ok = np.ones(len(rows), bool)
            qk = _keys(np.maximum(q, 0))
            idx = np.searchsorted(bkeys_sorted, qk)
            idx_c = np.minimum(idx, nb - 1)
            hit = ok & (bkeys_sorted[idx_c] == qk)
            if hit.any():
                hr = rows[hit]
                e[hr] = d
                j[hr] = border[idx_c[hit]]
                rows = rows[~hit]
        if len(rows):
            raise AssertionError(
                "EDT distance had no matching integer offset — "
                "EDT/matching disagree (bug)"
            )
    return e, j


def d2_psnr(
    ref_pts: np.ndarray,
    rec_pts: np.ndarray,
    depth: int = 10,
    radius: int = 63,
    normal_radius: int = 2,
    platform: str | None = None,
) -> dict:
    """Symmetric point-to-plane metrics between integer voxel clouds.

    Returns {"mse_ab", "mse_ba", "mse", "psnr"} with peak = 2^depth - 1 and
    the same 3*peak^2 numerator convention as :func:`~nvfpcc_tpu.metrics.d1.
    d1_psnr` (mirrors MPEG pc_error's geomPSNR convention so D1 and D2 are
    directly comparable)."""
    a = np.asarray(ref_pts, np.int64)
    b = np.asarray(rec_pts, np.int64)
    if len(a) == 0 or len(b) == 0:
        return {
            "mse_ab": math.inf, "mse_ba": math.inf,
            "mse": math.inf, "psnr": -math.inf,
        }
    normals = {}
    valid = {}
    normals["a"], valid["a"] = estimate_normals(a, normal_radius)
    normals["b"], valid["b"] = estimate_normals(b, normal_radius)

    def one_way(src, dst, nrm, vld):
        e, j = nn_vectors(src, dst, radius, platform)
        ef = e.astype(np.float64)
        proj = np.einsum("ij,ij->i", ef, nrm[j])
        sq = np.where(vld[j], proj * proj, np.einsum("ij,ij->i", ef, ef))
        return float(sq.mean())

    mse_ab = one_way(a, b, normals["b"], valid["b"])
    mse_ba = one_way(b, a, normals["a"], valid["a"])
    mse = max(mse_ab, mse_ba)
    peak = (1 << depth) - 1
    psnr = 10.0 * math.log10(3.0 * peak * peak / mse) if mse > 0 else math.inf
    return {"mse_ab": mse_ab, "mse_ba": mse_ba, "mse": mse, "psnr": psnr}
