"""Losses and metrics on dense occupancy grids (channels-last).

Rebuild of the active reference losses (``utils/loss.py``):

- ``focal_dense``       — focal BCE on probabilities (``:61-72``).
- ``surf_focal_dense``  — distance-weighted focal: weight = dist + mask*beta
  (``:94-111``), the main 'wfocal' loss (``NVFPCC.py:27,184``).
- ``acc_dense``         — pos/neg accuracy at a threshold (``:74-84``).
- ``sse1``              — SSE of the distance field over predicted-occupied
  voxels + count; feeds MSE1/PSNR1 (``:113-121``).
- ``multiscale_gt``     — max-pool GT pyramid [8^3, 16^3, 32^3]
  (``NVFPCC.py:76-88``).

All reductions are sums (matching the reference's un-normalized sums), f32.
An optional per-block ``block_mask`` supports padded batches under jit (the
reference's variable last batch, ``drop_last=False`` at ``NVFPCC.py:109-111``,
is realized as a fixed-shape masked batch under jit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _apply_block_mask(x, block_mask):
    if block_mask is None:
        return x
    return x * block_mask.reshape((-1,) + (1,) * (x.ndim - 1))


def focal_dense(pred, gt, alpha: float = 0.97, gamma: float = 2.0, block_mask=None):
    """Focal BCE on dense probability grids (reference ``get_focal_dense``)."""
    mask = gt.astype(bool)
    sign = jnp.where(mask, 1.0, -1.0)
    offs = jnp.where(mask, 0.0, 1.0)
    prob = pred * sign + offs  # p if occupied, (1-p) if empty
    alphas = alpha * sign + offs  # alpha if occupied, (1-alpha) if empty
    prob = jnp.clip(prob, 1e-9, None)
    loss = -alphas * (1.0 - prob) ** gamma * jnp.log(prob)
    loss = _apply_block_mask(loss, block_mask)
    return loss.sum()


def surf_focal_dense(
    pred, gt, dist, beta: float = 1.0, alpha: float = 0.97, gamma: float = 2.0, block_mask=None
):
    """Distance-weighted focal loss (reference ``get_surf_focal_dense``).

    Empty voxels are weighted by their distance to the surface; occupied
    voxels (dist == 0) get weight ``beta``.
    """
    mask = gt.astype(bool)
    sign = jnp.where(mask, 1.0, -1.0)
    offs = jnp.where(mask, 0.0, 1.0)
    dist_w = dist + mask * beta
    prob = pred * sign + offs
    alphas = alpha * sign + offs
    prob = jnp.clip(prob, 1e-9, None)
    loss = -alphas * (1.0 - prob) ** gamma * dist_w * jnp.log(prob)
    loss = _apply_block_mask(loss, block_mask)
    return loss.sum()


def acc_dense(pred, gt, thh: float = 0.5, block_mask=None):
    """(positive, negative) accuracy at threshold (reference ``get_acc_dense``).

    With a block mask, padded blocks contribute to neither numerator nor
    denominator.
    """
    mask = gt.astype(bool)
    imask = ~mask
    if block_mask is not None:
        bm = block_mask.reshape((-1,) + (1,) * (gt.ndim - 1)).astype(bool)
        mask = mask & bm
        imask = imask & bm
    tp = ((pred > thh) & mask).sum()
    ap = mask.sum()
    tn = ((pred <= thh) & imask).sum()
    an = imask.sum()
    # all-empty / all-occupied batches have an empty denominator; report
    # accuracy 1 over zero voxels rather than nan (sweep-metric hygiene)
    return (
        jnp.where(ap > 0, tp / jnp.maximum(ap, 1), 1.0),
        jnp.where(an > 0, tn / jnp.maximum(an, 1), 1.0),
    )


def sse1(pred, gt, dist, thh: float, block_mask=None):
    """(sum of squared distances over predicted-occupied voxels, count)
    (reference ``get_sse1``). MSE1 = sse/denom; PSNR1 = 20*log10(1023/sqrt(MSE1/3))."""
    occupied = (pred > thh).astype(jnp.float32)
    occupied = _apply_block_mask(occupied, block_mask)
    sq = jnp.square(occupied * dist)
    return sq.sum(), occupied.sum()


def psnr1_from_sse(sse_total: float, denom_total: float, maxv: float = 1023.0) -> float:
    """D1-proxy PSNR from accumulated sse1 terms (reference ``NVFPCC.py:259-260``)."""
    mse1 = sse_total / denom_total
    return float(20.0 * jnp.log10(maxv / jnp.sqrt(mse1 / 3.0)))


def multiscale_gt(gt):
    """GT pyramid [8^3, 16^3, 32^3] via 2x max-pool twice
    (reference ``MultiscaleProcessor``, ``NVFPCC.py:76-88``).

    ``gt`` is (B, 32, 32, 32, 1) channels-last.
    """

    def pool(x):
        return jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max, (1, 2, 2, 2, 1), (1, 2, 2, 2, 1), "VALID"
        )

    x1 = pool(gt)
    x2 = pool(x1)
    return [x2, x1, gt]
