"""Ground-truth grid builder: occupancy + distance grids per leaf block.

Capability rebuild of ``util_get_grids.py``: from a voxelized cloud and its
leaf-block origins, produce

- ``gt_grid``  (N, B, B, B) uint8 occupancy, and
- ``dist``     (N, B, B, B) float32 unsigned distance to the nearest cloud
  point (the loss weights / PSNR1 denominators).

The reference runs ~30M KD-tree queries on host (``util_get_grids.py:36-38``);
here the cloud is scattered into its bounding grid on device, an exact integer
squared EDT runs in three separable passes (``nvfpcc_tpu.grids.edt``), and the
per-block crops are gathered back. Distances match the KD-tree values exactly
(integer squared distances under float32 sqrt).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nvfpcc_tpu.grids.edt import squared_edt_3d

_ALIGN = 8  # pad bbox dims to multiples of this to bound recompilation

# Largest bounding grid (int32 bytes) built as one program; larger clouds go
# through z-slabs. Measured on an H100 (radius 55): a 2 GiB grid
# (1024x1024x512) peaks at 4.5 GiB of device memory and runs in 1.2 s, while
# a 4 GiB grid (1024^3) fails asking for 208 GiB — XLA no longer fuses the
# shifted slices of the windowed passes at that size.
MAX_GRID_BYTES = 2 << 30


def _block_radius(block: int) -> int:
    """Clamp radius: the largest possible in-block distance (block diagonal)."""
    return int(math.ceil(math.sqrt(3.0) * (block - 1))) + 1


@partial(jax.jit, static_argnames=("dims", "block", "radius"))
def _grids_kernel(rel_pts, rel_origins, dims, block, radius):
    """Scatter + EDT + per-block crops as ONE program: a single device
    dispatch, and no grid-sized intermediate leaves the device."""
    occ = jnp.zeros(dims, jnp.bool_)
    occ = occ.at[rel_pts[:, 0], rel_pts[:, 1], rel_pts[:, 2]].set(True)
    sq = squared_edt_3d(occ, radius)

    def crop(o):
        start = (o[0], o[1], o[2])
        return (
            jax.lax.dynamic_slice(occ, start, (block,) * 3),
            jax.lax.dynamic_slice(sq, start, (block,) * 3),
        )

    occ_b, sq_b = jax.vmap(crop)(rel_origins)
    return occ_b.astype(jnp.uint8), jnp.sqrt(sq_b.astype(jnp.float32))


def _one_grid(pts, orgs, lo, dims, block, radius, platform):
    """One _grids_kernel invocation on the chosen backend."""

    def run():
        # inputs must be created under the target device context — an input
        # committed to another device would drag the jit back onto it
        return _grids_kernel(
            jnp.asarray(pts - lo, jnp.int32),
            jnp.asarray(orgs - lo, jnp.int32),
            tuple(int(d) for d in dims),
            int(block),
            int(radius),
        )

    if platform is None:
        gt, dist = run()
    else:
        with jax.default_device(jax.local_devices(backend=platform)[0]):
            gt, dist = run()
    return np.asarray(gt), np.asarray(dist)


def build_block_grids(
    points: np.ndarray,
    origins: np.ndarray,
    block: int = 32,
    radius: int | None = None,
    platform: str | None = None,
    max_grid_bytes: int = MAX_GRID_BYTES,
):
    """Build (gt_grid uint8 (N,B,B,B), dist float32 (N,B,B,B)).

    ``points``: (P, 3) integer voxel coordinates. ``origins``: (N, 3) block
    origins (multiples of ``block``).

    ``platform``: backend for the one-shot preprocessing program; ``None``
    (default) is the ambient default device, ``"cpu"`` pins it to the host
    (the plain reference the device grids are checked against).

    When the bounding grid exceeds ``max_grid_bytes`` (vox11+ scale: a full
    2048^3 region would need ~35 GB), the volume is processed in z-slabs of
    whole blocks with a ``radius`` halo. The window-clamped EDT's support is
    bounded by ``radius`` per axis, so slab results are exact — and every
    slab is padded to one common shape, so XLA compiles a single program.
    """
    pts = np.asarray(points, dtype=np.int64)
    orgs = np.asarray(origins, dtype=np.int64)
    if radius is None:
        radius = _block_radius(block)

    # Bounding grid over all leaf blocks, padded by the clamp radius so the
    # window never reads out of bounds of real data, then aligned.
    lo = orgs.min(axis=0) - radius
    hi = orgs.max(axis=0) + block + radius
    dims = ((hi - lo + _ALIGN - 1) // _ALIGN) * _ALIGN

    if int(np.prod(dims)) * 4 <= max_grid_bytes:
        return _one_grid(pts, orgs, lo, dims, block, radius, platform)

    # --- slab-tiled path ---
    zs = np.unique(orgs[:, 2])
    # z-extent of one slab (in block origins) so that the slab grid fits
    xy_cells = int(dims[0] * dims[1])
    z_budget = max(block, int(max_grid_bytes // (4 * xy_cells)) - 2 * radius)
    z_budget = (z_budget // block) * block or block
    bands = []
    z0 = int(zs.min())
    z_end = int(zs.max())
    while z0 <= z_end:
        sel = (orgs[:, 2] >= z0) & (orgs[:, 2] < z0 + z_budget)
        if sel.any():
            bands.append(sel)
        z0 += z_budget

    # common slab shape + common point capacity -> one compiled program
    slab_dims = np.array(
        [dims[0], dims[1], ((z_budget + 2 * radius + _ALIGN - 1) // _ALIGN) * _ALIGN]
    )
    max_pts = 0
    band_data = []
    for sel in bands:
        o_b = orgs[sel]
        z_lo = int(o_b[:, 2].min()) - radius
        p_sel = (pts[:, 2] >= z_lo) & (pts[:, 2] < z_lo + slab_dims[2])
        band_data.append((sel, o_b, p_sel, z_lo))
        max_pts = max(max_pts, int(p_sel.sum()))

    gt = np.empty((len(orgs), block, block, block), np.uint8)
    dist = np.empty((len(orgs), block, block, block), np.float32)
    for sel, o_b, p_sel, z_lo in band_data:
        lo_b = np.array([lo[0], lo[1], z_lo])
        p_b = pts[p_sel]
        if len(p_b) < max_pts:  # pad with a repeated point (idempotent scatter)
            p_b = np.concatenate([p_b, np.repeat(p_b[:1], max_pts - len(p_b), 0)])
        g_b, d_b = _one_grid(p_b, o_b, lo_b, slab_dims, block, radius, platform)
        gt[sel] = g_b
        dist[sel] = d_b
    return gt, dist


def validate_dist_grids(
    points: np.ndarray,
    origins: np.ndarray,
    dist: np.ndarray,
    block: int,
    radius: int | None = None,
    n_probes: int = 256,
    seed: int = 0,
) -> None:
    """Probe-check distance grids against brute-force NN (host numpy).

    Guardrail against device miscompiles (phantom-close distances are the
    failure mode a wrong lowering of the windowed passes produces). Samples
    ``n_probes`` random block voxels and verifies each against an exact NN
    search over the cloud. Raises on any mismatch. Cost: a few seconds per
    cloud — preprocessing runs once.
    """
    pts = np.asarray(points, np.int64)
    orgs = np.asarray(origins, np.int64)
    if radius is None:
        radius = _block_radius(block)
    cap_sq = radius * radius + 1
    rng = np.random.default_rng(seed)
    bi = rng.integers(0, len(orgs), n_probes)
    vi = rng.integers(0, block, (n_probes, 3))
    for t in range(n_probes):
        p = orgs[bi[t]] + vi[t]
        best = cap_sq
        for c in range(0, len(pts), 500_000):
            d = int(((pts[c : c + 500_000] - p) ** 2).sum(1).min())
            best = min(best, d)
        want_sq = min(best, cap_sq)
        got = float(dist[bi[t], vi[t, 0], vi[t, 1], vi[t, 2]])
        # distances are sqrt(int); compare the squared integers so 1-ulp
        # f32 sqrt differences between device and host don't false-alarm
        if int(round(got * got)) != want_sq:
            raise RuntimeError(
                f"distance-grid validation failed at block {bi[t]} voxel "
                f"{tuple(vi[t])}: got {got} (d^2~{got*got:.2f}), brute force "
                f"d^2={want_sq} — device EDT miscompile?"
            )


def build_artifacts(
    points,
    depth: int = 10,
    level: int = 5,
    platform: str | None = None,
    validate: bool = True,
):
    """Full preprocessing: origins + gt + dist (the reference's three .npy
    artifacts, ``util_get_grids.py:16-46``). ``validate`` probe-checks the
    distance field against brute force (cheap; see validate_dist_grids)."""
    from nvfpcc_tpu.octree.partition import leaf_origins

    block = 1 << (depth - level)
    origins = leaf_origins(points, depth, level)
    gt, dist = build_block_grids(points, origins, block, platform=platform)
    if validate:
        validate_dist_grids(points, origins, dist, block)
    return origins, gt, dist
