"""The windowed separable EDT (``grids/edt.py``) against an independent
reference, its placement on the ambient device, and the grids guardrail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from nvfpcc_tpu.grids import builder as B
from nvfpcc_tpu.grids.edt import squared_edt_3d
from nvfpcc_tpu.octree.partition import leaf_origins


@pytest.mark.parametrize(
    "shape,radius,seed",
    [((16, 16, 16), 5, 0), ((24, 32, 40), 9, 1), ((8, 8, 256), 20, 2), ((64, 64, 64), 55, 3)],
)
def test_edt_matches_scipy(shape, radius, seed):
    """Exact squared distance, saturated at radius^2 + 1: scipy's exact
    Euclidean transform of the empty voxels, squared, rounded and capped."""
    rng = np.random.default_rng(seed)
    occ = rng.uniform(0, 1, shape) < 0.01
    assert occ.any()
    want = np.minimum(
        np.rint(ndimage.distance_transform_edt(~occ) ** 2).astype(np.int64),
        radius * radius + 1,
    )
    got = np.asarray(squared_edt_3d(jnp.asarray(occ), radius))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_edt_runs_on_the_ambient_device():
    """One EDT, no per-platform routing: the grids program runs on whatever
    device is the default, and the result does not depend on which."""
    rng = np.random.default_rng(4)
    pts = np.unique(rng.integers(0, 64, (400, 3)), axis=0)
    origins = leaf_origins(pts, 6, 1)
    radius = B._block_radius(32)
    lo = origins.min(0) - radius
    dims = (128, 128, 128)
    target = jax.devices()[3]
    with jax.default_device(target):
        gt, dist = B._grids_kernel(
            jnp.asarray(pts - lo, jnp.int32), jnp.asarray(origins - lo, jnp.int32),
            dims, 32, radius,
        )
    assert gt.devices() == {target} and dist.devices() == {target}
    gt_host, dist_host = B.build_block_grids(pts, origins, 32, platform="cpu")
    gt_amb, dist_amb = B.build_block_grids(pts, origins, 32)
    assert np.array_equal(np.asarray(gt), gt_host) and np.array_equal(gt_amb, gt_host)
    assert np.array_equal(np.asarray(dist), dist_host)
    assert np.array_equal(dist_amb, dist_host)


def test_validation_guardrail_catches_corruption():
    rng = np.random.default_rng(0)
    pts = np.unique(rng.integers(0, 64, (300, 3)), axis=0)
    origins = leaf_origins(pts, 6, 1)
    gt, dist = B.build_block_grids(pts, origins, 32)
    B.validate_dist_grids(pts, origins, dist, 32)  # clean: passes
    bad = dist * 0.5  # phantom-close everywhere (the observed failure mode)
    with pytest.raises(RuntimeError, match="validation failed"):
        B.validate_dist_grids(pts, origins, bad, 32)
