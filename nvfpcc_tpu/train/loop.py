"""Jitted training loop: per-batch net updates + once-per-epoch embedding update.

Rebuild of the reference training dynamics (``NVFPCC.py:103-393``) as two
jitted programs (one per quantization phase q=1/q=2):

- The per-batch loop (reference ``NVFPCC.py:149-223``) becomes a
  ``lax.scan`` over fixed-shape index batches; the variable last batch
  (``drop_last=False``) is realized as a padded batch with a block mask so
  shapes stay static under jit. Net parameters update per batch with Adam;
  embedding rows are gathered but treated as constants (the reference
  discards their accumulated grads at ``opt_emb.zero_grad()``).
- The once-per-epoch full-set embedding update (reference ``NVFPCC.py:225-251``)
  runs the whole leaf set through the model and steps a second Adam on the
  embedding tensor only. This is the whole-volume operation that shards across
  the device mesh (see ``nvfpcc_tpu.parallel``).
- Epochs between eval/checkpoint boundaries are CHUNKED into one program
  (an outer ``lax.scan`` over the same epoch body — ``make_epochs_fn``): each
  dispatch + metrics fetch is a host round-trip, and nothing host-side needs
  to run between evals. Trajectory is unchanged
  (bitwise on params; tested in ``tests/test_train_chunking.py``).

Scheduling: MultiStepLR([300,400,450], 0.1) on the net optimizer. The
reference constructs *both* schedulers over the net optimizer
(``NVFPCC.py:126``), so its net lr decays x0.01 per milestone and the
embedding lr never decays; ``TrainConfig.ref_sched_quirk`` reproduces that,
default is the evidently intended x0.1 / x0.1.

Everything on-device stays f32; gt/dist grids live in device memory for the
whole run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nvfpcc_tpu.config import ModelConfig, TrainConfig
from nvfpcc_tpu.models import decoder as M
from nvfpcc_tpu.train import losses as L


@dataclass
class TrainState:
    params: dict
    opt_state: object
    emb: jnp.ndarray
    emb_opt_state: object
    epoch: int = 0


def _lr_schedule(cfg: TrainConfig, steps_per_epoch: int, decay: float):
    boundaries = {int(m) * steps_per_epoch: decay for m in cfg.milestones}
    return optax.piecewise_constant_schedule(cfg.lr, boundaries)


def make_optimizers(cfg: TrainConfig, steps_per_epoch: int):
    """(net_opt, emb_opt) with MultiStepLR-style schedules."""
    if cfg.ref_sched_quirk:
        net_decay, emb_decay = cfg.lr_decay**2, 1.0
    else:
        net_decay, emb_decay = cfg.lr_decay, cfg.lr_decay
    net_opt = optax.adam(_lr_schedule(cfg, steps_per_epoch, net_decay))
    emb_sched = optax.piecewise_constant_schedule(
        cfg.lr * cfg.wemb, {int(m): emb_decay for m in cfg.milestones}
    )
    emb_opt = optax.adam(emb_sched)
    return net_opt, emb_opt


def batch_plan(n_blocks: int, batch_size: int, shuffle: str, seed: int, epoch: int):
    """(idx (n_batches, B) int32, mask (n_batches, B) f32) covering all blocks.

    'stride' reproduces the reference pseudo-shuffle ``idx*2113 % N``
    (``utils/dataloader.py:165-167``). Padding rows are masked out.
    """
    if shuffle == "stride":
        perm = (np.arange(n_blocks, dtype=np.int64) * 2113) % n_blocks
    elif shuffle == "random":
        perm = np.random.default_rng(seed * 100003 + epoch).permutation(n_blocks)
    else:
        perm = np.arange(n_blocks)
    n_batches = -(-n_blocks // batch_size)
    pad = n_batches * batch_size - n_blocks
    idx = np.concatenate([perm, np.zeros(pad, np.int64)])
    mask = np.concatenate([np.ones(n_blocks, np.float32), np.zeros(pad, np.float32)])
    return (
        idx.reshape(n_batches, batch_size).astype(np.int32),
        mask.reshape(n_batches, batch_size),
    )


def rd_weights(cfg: TrainConfig) -> jnp.ndarray:
    """(lambda, w1, w2) as a runtime array — passed into the jitted programs
    as data, NOT baked as constants, so an RD sweep over lambda reuses one
    compiled epoch program (compile-once, sweep-many)."""
    return jnp.asarray([cfg.lmbda, cfg.w1, cfg.w2], jnp.float32)


def rd_loss(
    spec: M.ModelSpec,
    cfg: TrainConfig,
    params: dict,
    emb_b: jnp.ndarray,
    gt_b: jnp.ndarray,
    dist_b: jnp.ndarray,
    block_mask: Optional[jnp.ndarray],
    n_total_pts: float,
    mode: str,
    q: int,
    key: Optional[jax.Array],
    rd_w: Optional[jnp.ndarray] = None,
    compute_dtype=None,
    n_pts_override=None,
):
    """The reference's full RD objective + metrics (``NVFPCC.py:160-196``).

    ``gt_b``/``dist_b`` are (B, 32, 32, 32, 1) channels-last.
    ``rd_w`` is the (lambda, w1, w2) array (defaults to cfg's values).
    ``compute_dtype`` runs the decoder convs at lower precision (train-time
    mixed precision; see ``models.decoder.decoder_apply``) — the loss and
    rate math here stay f32 either way.
    Returns (loss, metrics dict).
    """
    out, cls_list, net_bits, latent_bits_pb = M.net_apply(
        spec, params, emb_b, mode, q, key, compute_dtype=compute_dtype
    )
    if rd_w is None:
        rd_w = rd_weights(cfg)

    if block_mask is not None:
        n_pts = (gt_b.reshape(gt_b.shape[0], -1).sum(1) * block_mask).sum()
        latent_bits = (latent_bits_pb * block_mask).sum()
    else:
        n_pts = gt_b.sum()
        latent_bits = latent_bits_pb.sum()
    if n_pts_override is not None:
        # chunked full-set emb update: every chunk must normalize its latent
        # rate by the GLOBAL point count so grad-of-sum == sum-of-chunk-grads
        n_pts = n_pts_override

    b_latent = latent_bits / n_pts
    b_net = net_bits.sum() / n_total_pts
    bpp = b_latent + b_net
    bpp_loss = b_latent * rd_w[1] + b_net * rd_w[2]

    ms = L.multiscale_gt(gt_b)
    ms_bce0 = L.focal_dense(cls_list[0], ms[0], alpha=cfg.ms_alpha, block_mask=block_mask)
    ms_bce1 = L.focal_dense(cls_list[1], ms[1], alpha=cfg.ms_alpha, block_mask=block_mask)
    bce = L.surf_focal_dense(
        out, gt_b, dist_b, beta=cfg.beta, alpha=cfg.focal_alpha, block_mask=block_mask
    )
    loss = bce + ms_bce0 + ms_bce1 + rd_w[0] * bpp_loss

    pacc, nacc = L.acc_dense(out, gt_b, block_mask=block_mask)
    sse, denom = L.sse1(out, gt_b, dist_b, cfg.sse_thh, block_mask=block_mask)
    # codable-alphabet guard: the coder clamps rounded latents outside
    # [-512, 512); track the max magnitude so drift toward the edge is
    # caught during training, not first at encode time (codec.py warns there
    # too, but by then the rate is already paid).
    lat = jax.lax.stop_gradient(M.latent_gen_apply(spec, params, emb_b))
    lat = jnp.abs(jnp.rint(lat))
    if block_mask is not None:
        lat = lat * block_mask.reshape((-1,) + (1,) * (lat.ndim - 1))
    lat_amax = lat.max()
    metrics = {
        "loss": loss,
        "bce": bce,
        "ms0": ms_bce0,
        "ms1": ms_bce1,
        "pacc": pacc,
        "nacc": nacc,
        "bpp": bpp,
        "b_latent": b_latent,
        "b_net": b_net,
        "sse": sse,
        "denom": denom,
        "lat_amax": lat_amax,
    }
    return loss, metrics


def _prep_dense(gt: np.ndarray, dist: np.ndarray):
    """Host grids (N,B,B,B) -> device channels-last f32 (N,B,B,B,1)."""
    gt_d = jnp.asarray(gt, jnp.float32)[..., None]
    dist_d = jnp.asarray(dist, jnp.float32)[..., None]
    return gt_d, dist_d


# auto emb-update chunking kicks in above this block count: every vox10
# artifact (<= 2716 blocks) keeps its single-program update (byte-identical
# programs -> persistent-cache hits), while vox11-scale clouds (5326+ blocks,
# whose all-blocks f32 conv activations are ~13 GB: a (5326,35,35,35,8)
# activation alone is 6.8 GB) split into chunks of at most this many blocks.
# The chunking is exact (make_emb_full_grad), so the bound only trades peak
# device memory against one program per chunk.
EMB_CHUNK_BLOCKS = 4096


def resolve_emb_chunks(requested: int, n_blocks: int) -> int:
    """0 = auto: smallest chunk count keeping <= EMB_CHUNK_BLOCKS blocks per
    chunk; any positive value is taken as-is."""
    if requested and requested > 0:
        return int(requested)
    return max(1, -(-n_blocks // EMB_CHUNK_BLOCKS))


def make_emb_full_grad(spec, cfg, n_total_pts, q, emb_chunks=1):
    """Gradient of the full-set embedding loss (reference NVFPCC.py:225-251),
    optionally computed in ``emb_chunks`` sequential block chunks
    (``lax.map``) instead of one all-blocks program.

    The decomposition is exact for every DETERMINISTIC form: all loss terms
    are sums over blocks, and the one global normalizer (the full-set point
    count dividing the latent rate) is computed once and passed into each
    chunk — grad-of-sum == concat-of-chunk-grads (tested bitwise-close in
    ``tests/test_train_chunking.py``). Noise forms draw from per-chunk folded
    keys — a different (statistically identical) stream than the unchunked
    program. Concretely: ctx modes at q=2 are key-free (chunked == unchunked
    up to float reassociation); channel/gaussian modes add rate noise at
    every train step (``entropy_apply``), so their chunked draws differ at
    q=1 AND q=2 — in production this never bites: auto-chunking engages only
    above EMB_CHUNK_BLOCKS blocks, i.e. vox11 scale, where the train gate
    picks ctx. Peak device memory for the update scales 1/chunks (the all-blocks conv
    activations are the OOM driver at vox11: a (5326,35,35,35,8) f32
    activation alone is 6.8 GB). Requires the block count to be a multiple of
    ``emb_chunks`` (train() pads)."""

    cd = getattr(cfg, "compute_dtype", "f32")

    def emb_loss(emb, params, gt, dist, block_valid, key, rd_w, n_pts_g=None):
        loss, _ = rd_loss(
            spec, cfg, jax.lax.stop_gradient(params), emb, gt, dist, block_valid,
            n_total_pts, "train", q, key, rd_w, compute_dtype=cd,
            n_pts_override=n_pts_g,
        )
        return loss

    def emb_full_grad(emb, params, gt, dist, block_valid, key, rd_w):
        if emb_chunks <= 1:
            return jax.grad(emb_loss)(emb, params, gt, dist, block_valid, key, rd_w)
        n = emb.shape[0]
        c = emb_chunks
        assert n % c == 0, f"padded block count {n} not a multiple of emb_chunks {c}"
        n_pts_g = (gt.reshape(n, -1).sum(1) * block_valid).sum()
        keys_c = jax.random.split(key, c)

        def r(x):
            return x.reshape((c, n // c) + x.shape[1:])

        def chunk_grad(xs):
            emb_c, gt_c, dist_c, bv_c, kc = xs
            return jax.grad(emb_loss)(
                emb_c, params, gt_c, dist_c, bv_c, kc, rd_w, n_pts_g
            )

        grads = jax.lax.map(
            chunk_grad, (r(emb), r(gt), r(dist), r(block_valid), keys_c)
        )
        return grads.reshape(emb.shape)

    return emb_full_grad


def _epoch_body(spec, cfg, net_opt, emb_opt, n_total_pts, q, emb_chunks=1):
    """(carry, per-epoch inputs) -> (carry, metrics) — one full epoch: scan of
    per-batch net updates, then the full-set embedding update (chunked per
    :func:`make_emb_full_grad` when ``emb_chunks > 1``). Shared by the
    single-epoch and chunked programs so both trace identical math."""

    cd = getattr(cfg, "compute_dtype", "f32")

    def net_loss(params, emb_b, gt_b, dist_b, mask, key, rd_w):
        return rd_loss(
            spec, cfg, params, jax.lax.stop_gradient(emb_b), gt_b, dist_b, mask,
            n_total_pts, "train", q, key, rd_w, compute_dtype=cd,
        )

    emb_full_grad = make_emb_full_grad(spec, cfg, n_total_pts, q, emb_chunks)

    def one_epoch(params, opt_state, emb, emb_opt_state, gt, dist, idx, mask,
                  block_valid, key, rd_w):
        n_batches = idx.shape[0]
        keys = jax.random.split(key, n_batches + 1)

        def batch_step(carry, xs):
            params, opt_state = carry
            bidx, bmask, bkey = xs
            gt_b = gt[bidx]
            dist_b = dist[bidx]
            emb_b = emb[bidx]
            (_, metrics), grads = jax.value_and_grad(net_loss, has_aux=True)(
                params, emb_b, gt_b, dist_b, bmask, bkey, rd_w
            )
            updates, opt_state = net_opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), metrics

        (params, opt_state), metrics = jax.lax.scan(
            batch_step, (params, opt_state), (idx, mask, keys[:n_batches])
        )

        # full-set embedding update (reference NVFPCC.py:225-251)
        emb_grads = emb_full_grad(emb, params, gt, dist, block_valid, keys[-1], rd_w)
        emb_updates, emb_opt_state = emb_opt.update(emb_grads, emb_opt_state, emb)
        emb = optax.apply_updates(emb, emb_updates)

        return params, opt_state, emb, emb_opt_state, metrics

    return one_epoch


def make_epoch_fn(
    spec: M.ModelSpec,
    cfg: TrainConfig,
    net_opt,
    emb_opt,
    n_total_pts: float,
    q: int,
    emb_chunks: int = 1,
) -> Callable:
    """One jitted epoch. Compiled once per q phase."""
    one_epoch = _epoch_body(spec, cfg, net_opt, emb_opt, n_total_pts, q, emb_chunks)

    # donate the threaded state: params/opt/emb buffers update in place on
    # device instead of being copied every epoch
    @partial(jax.jit, donate_argnums=(0, 1, 2, 3))
    def epoch_fn(
        params, opt_state, emb, emb_opt_state, gt, dist, idx, mask, block_valid,
        key, rd_w,
    ):
        return one_epoch(
            params, opt_state, emb, emb_opt_state, gt, dist, idx, mask,
            block_valid, key, rd_w,
        )

    return epoch_fn


def make_epochs_fn(
    spec: M.ModelSpec,
    cfg: TrainConfig,
    net_opt,
    emb_opt,
    n_total_pts: float,
    q: int,
    emb_chunks: int = 1,
) -> Callable:
    """A CHUNK of epochs as one jitted program: ``lax.scan`` over K epochs of
    the same per-epoch body as :func:`make_epoch_fn`, so the trajectory is
    bit-identical to K single-epoch calls (keys are derived inside the
    program via the same ``fold_in(base_key, epoch)`` the host loop used).

    Motivation: every program dispatch and every metrics fetch is a host
    round-trip, and a per-epoch sync serializes host against device.
    Chunking the epochs between eval/checkpoint boundaries (default cadence
    10) amortizes that to one round-trip per chunk. Stacked per-epoch inputs:
    ``idx``/``mask`` gain a leading K axis, ``epoch_nums`` is the (K,) int32
    epoch-number vector, and the stacked per-epoch metrics come back
    (K, n_batches).
    """
    one_epoch = _epoch_body(spec, cfg, net_opt, emb_opt, n_total_pts, q, emb_chunks)

    @partial(jax.jit, donate_argnums=(0, 1, 2, 3))
    def epochs_fn(
        params, opt_state, emb, emb_opt_state, gt, dist, idx, mask, block_valid,
        base_key, epoch_nums, rd_w,
    ):
        def body(carry, xs):
            params, opt_state, emb, emb_opt_state = carry
            e_idx, e_mask, e_num = xs
            key = jax.random.fold_in(base_key, e_num)
            params, opt_state, emb, emb_opt_state, metrics = one_epoch(
                params, opt_state, emb, emb_opt_state, gt, dist, e_idx, e_mask,
                block_valid, key, rd_w,
            )
            return (params, opt_state, emb, emb_opt_state), metrics

        (params, opt_state, emb, emb_opt_state), metrics = jax.lax.scan(
            body, (params, opt_state, emb, emb_opt_state),
            (idx, mask, epoch_nums),
        )
        return params, opt_state, emb, emb_opt_state, metrics

    return epochs_fn


def make_eval_fn(spec: M.ModelSpec, cfg: TrainConfig, n_total_pts: float):
    """Full-set eval at q=2 rounded latents (reference ``NVFPCC.py:308-364``)."""

    @jax.jit
    def eval_fn(params, emb, gt, dist, block_valid, rd_w):
        _, metrics = rd_loss(
            spec, cfg, params, emb, gt, dist, block_valid, n_total_pts, "eval", 2,
            None, rd_w,
        )
        return metrics

    return eval_fn


def summarize_metrics(metrics) -> dict:
    """Average scan-stacked metrics the way the reference prints them
    (per-batch means; MSE1/PSNR1 from summed sse/denom, ``NVFPCC.py:256-281``)."""
    out = {}
    m = {k: np.asarray(v) for k, v in metrics.items()}
    cnt = max(m["loss"].size, 1)
    for k in ("loss", "bce", "ms0", "ms1", "pacc", "nacc", "bpp", "b_latent", "b_net"):
        out[k] = float(m[k].sum() / cnt) if m[k].ndim else float(m[k])
    sse, denom = float(m["sse"].sum()), float(m["denom"].sum())
    out["mse1"] = sse / max(denom, 1.0)
    out["psnr1"] = L.psnr1_from_sse(sse, max(denom, 1e-9))
    if "lat_amax" in m:
        out["lat_amax"] = float(m["lat_amax"].max())
    return out


class TrainDivergence(RuntimeError):
    """Raised when the loss goes non-finite (the reference instead drops into
    an interactive IPython shell, ``NVFPCC.py:199-212``; a framework raises)."""


# warn when a rounded latent approaches the coder's +-512 alphabet edge: past
# it the codec clamps (parity-safe but rate-lossy), so drift should surface
# during training, not at encode time
LATENT_GUARD = 480.0


def initial_params(spec: M.ModelSpec, model_cfg: ModelConfig) -> dict:
    """Training start params. ``model_cfg.ctx_train_init="feature"`` swaps
    the ctx predictor's zero init for the working pass-through feature init —
    measured WORSE for co-training (the zero init's optimization deadlock is
    load-bearing for the co-trained rate cuts; RESULTS.md round 3, E1/E3),
    kept selectable for decision artifacts and experimentation."""
    params = M.init_params(spec)
    if (
        spec.entropy_mode in M.CTX_MODES
        and getattr(model_cfg, "ctx_train_init", "zero") == "feature"
    ):
        params["entropy"] = M.ctx_feature_init(spec)
    return params


def train(
    gt: np.ndarray,
    dist: np.ndarray,
    model_cfg: ModelConfig,
    cfg: TrainConfig,
    checkpoint_dir: Optional[str] = None,
    log: Callable[[str], None] = print,
    mesh=None,
    resume: bool = False,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
):
    """Full training run (reference ``train()``, ``NVFPCC.py:103-393``).

    ``gt`` (N,B,B,B) uint8, ``dist`` (N,B,B,B) f32. Returns (spec, TrainState).
    When ``mesh`` is given, block-sharded arrays and replicated params are laid
    out per ``nvfpcc_tpu.parallel``. With ``resume=True`` the latest full
    train-state snapshot in ``checkpoint_dir`` (params + both Adam states +
    epoch) is restored — a capability the reference lacks (SURVEY §5).
    ``metrics_path`` appends one JSON line of metrics per epoch.
    """
    import json

    from nvfpcc_tpu.utils import checkpoint as ckpt_util

    n_blocks = int(gt.shape[0])
    n_total_pts = float(gt.sum())
    spec = M.build_model_spec(
        model_cfg.ch, model_cfg.channels, model_cfg.seed_tag,
        model_cfg.entropy_mode, getattr(model_cfg, "ctx_detach_pred", False),
        getattr(model_cfg, "ctx_hidden", M.CTX_HIDDEN),
        ctx_tail=getattr(model_cfg, "ctx_tail", 0),
    )

    # With a mesh, pad the block axis to a multiple of the mesh size (GSPMD
    # needs even shards); padding rows are masked out of every loss term via
    # block_valid.
    if mesh is not None:
        from nvfpcc_tpu.parallel import mesh as pm

        n_padded = pm.padded_block_count(n_blocks, mesh)
        gt = pm.pad_blocks(np.asarray(gt), n_padded)
        dist = pm.pad_blocks(np.asarray(dist), n_padded)
        # block-DP already splits the full-set emb grad across devices; the
        # single-program OOM the chunking addresses does not arise there
        emb_chunks = 1
    else:
        n_padded = n_blocks
        emb_chunks = resolve_emb_chunks(
            getattr(cfg, "emb_chunks", 0), n_blocks
        )
        if emb_chunks > 1 and n_padded % emb_chunks:
            n_padded = n_padded + (-n_padded) % emb_chunks

            def _pad_n(a, n):
                a = np.asarray(a)
                pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
                return np.concatenate([a, pad])

            gt = _pad_n(gt, n_padded)
            dist = _pad_n(dist, n_padded)
    block_valid = jnp.asarray(
        np.concatenate(
            [np.ones(n_blocks, np.float32), np.zeros(n_padded - n_blocks, np.float32)]
        )
    )

    params = initial_params(spec, model_cfg)
    emb = M.init_embeddings(n_padded, model_cfg.ch)

    steps_per_epoch = -(-n_blocks // cfg.batch_size)
    net_opt, emb_opt = make_optimizers(cfg, steps_per_epoch)
    opt_state = net_opt.init(params)
    emb_opt_state = emb_opt.init(emb)

    gt_d, dist_d = _prep_dense(gt, dist)
    if mesh is not None:
        params, opt_state, emb, emb_opt_state, gt_d, dist_d = pm.shard_train_arrays(
            mesh, params, opt_state, emb, emb_opt_state, gt_d, dist_d
        )
        block_valid = jax.device_put(block_valid, pm.block_sharding(mesh))

    epoch_fns = {
        q: make_epochs_fn(spec, cfg, net_opt, emb_opt, n_total_pts, q, emb_chunks)
        for q in (1, 2)
    }
    eval_fn = make_eval_fn(spec, cfg, n_total_pts)
    base_key = jax.random.PRNGKey(cfg.seed)
    rd_w = rd_weights(cfg)

    start_epoch = 0
    state = TrainState(params, opt_state, emb, emb_opt_state)
    if resume and checkpoint_dir is not None:
        snap_path = ckpt_util.latest_train_state(checkpoint_dir)
        if snap_path is not None:
            snap = ckpt_util.load_train_state(snap_path)
            if snap["emb"].shape[0] != n_padded:
                raise ValueError(
                    f"snapshot block axis {snap['emb'].shape[0]} != {n_padded} "
                    "(mesh size changed since the snapshot?)"
                )
            r_params, r_opt, r_emb, r_emb_opt = (
                snap["params"], snap["opt_state"],
                jnp.asarray(snap["emb"]), snap["emb_opt_state"],
            )
            if mesh is not None:
                r_params, r_opt, r_emb, r_emb_opt, gt_d, dist_d = pm.shard_train_arrays(
                    mesh, r_params, r_opt, r_emb, r_emb_opt, gt_d, dist_d
                )
            state = TrainState(r_params, r_opt, r_emb, r_emb_opt, snap["epoch"])
            start_epoch = snap["epoch"] + 1
            log(f"[train] resumed from {snap_path} (epoch {snap['epoch']})")

    # Profile a post-compile window (epochs 3-5): first epochs are compile
    # noise; the reference's only tracing is wall-clock prints (SURVEY §5).
    prof_start, prof_stop = 3, 5

    def chunk_end(e0: int) -> int:
        """Last epoch (inclusive) of the chunk starting at e0: stop at the
        next eval/checkpoint boundary, the q phase change, and the end —
        within a chunk no host code needs to run, so the whole chunk is one
        program dispatch (one host round-trip instead of one per epoch)."""
        e1 = cfg.epochs - 1
        if cfg.eval_every > 0:
            n_boundary = e0 + (-e0) % cfg.eval_every  # first e >= e0, e % eval_every == 0
            e1 = min(e1, n_boundary)
        if e0 < cfg.phase_change:
            e1 = min(e1, cfg.phase_change - 1)
        if profile_dir is not None and e0 <= prof_stop + 1:
            e1 = e0  # keep the profile window's epoch boundaries host-visible
        return e1

    profiling = False
    epoch = start_epoch
    while epoch < cfg.epochs:
        e0, e1 = epoch, chunk_end(epoch)
        k_epochs = e1 - e0 + 1
        if profile_dir is not None and e0 == prof_start:
            jax.profiler.start_trace(profile_dir)
            profiling = True
        t0 = time.time()
        q = 1 if e0 < cfg.phase_change else 2
        plans = [
            batch_plan(n_blocks, cfg.batch_size, cfg.shuffle, cfg.seed, e)
            for e in range(e0, e1 + 1)
        ]
        idx = np.stack([p[0] for p in plans])
        mask = np.stack([p[1] for p in plans])
        params, opt_state, emb, emb_opt_state, metrics = epoch_fns[q](
            state.params, state.opt_state, state.emb, state.emb_opt_state,
            gt_d, dist_d, jnp.asarray(idx), jnp.asarray(mask), block_valid,
            base_key, jnp.arange(e0, e1 + 1, dtype=jnp.int32), rd_w,
        )
        state = TrainState(params, opt_state, emb, emb_opt_state, e1)
        # fetching the metrics waits for the chunk's last step, so the chunk
        # time covers device execution, not just the asynchronous dispatch
        metrics = jax.device_get(metrics)
        chunk_s = (time.time() - t0) / k_epochs
        if profiling and e0 >= prof_stop:
            jax.profiler.stop_trace()
            log(f"[train] profiler trace written to {profile_dir}")
            profiling, profile_dir = False, None
        for k, epoch in enumerate(range(e0, e1 + 1)):
            s = summarize_metrics({name: v[k] for name, v in metrics.items()})
            if not np.isfinite(s["loss"]):
                raise TrainDivergence(
                    f"non-finite loss at epoch {epoch} (q={q}): {s}"
                )
            if metrics_path is not None:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "q": q, **s}) + "\n")
            log(
                f"[Epoch {epoch:04d} TRAIN {chunk_s:.3f}s] "
                f"Loss: {s['loss']:.4e} Pacc: {s['pacc']:.4f} Nacc: {s['nacc']:.4f} "
                f"S1: {s['ms0']:.1f} S2: {s['ms1']:.1f} bpp: {s['bpp']:.4f} "
                f"b_latent: {s['b_latent']:.4f} b_net: {s['b_net']:.4f} "
                f"MSE1: {s['mse1']:.4f} PSNR1: {s['psnr1']:.4f}"
            )

        if cfg.eval_every > 0 and epoch % cfg.eval_every == 0:
            es = summarize_metrics(
                jax.device_get(eval_fn(params, emb, gt_d, dist_d, block_valid, rd_w))
            )
            if es.get("lat_amax", 0.0) > LATENT_GUARD:
                import warnings

                warnings.warn(
                    f"epoch {epoch}: max |rounded latent| = {es['lat_amax']:.0f} "
                    f"is approaching the coder alphabet edge (512); encode "
                    "will clamp (rate loss). Consider a larger lambda*w1 or "
                    "checking for divergence."
                )
            log(
                f"[Epoch {epoch:04d} TEST] Loss: {es['loss']:.4e} "
                f"Pacc: {es['pacc']:.4f} Nacc: {es['nacc']:.4f} bpp: {es['bpp']:.4f} "
                f"b_latent: {es['b_latent']:.4f} b_net: {es['b_net']:.4f} "
                f"MSE1: {es['mse1']:.4f} PSNR1: {es['psnr1']:.4f}"
            )
            if checkpoint_dir is not None:
                # multi-host: block-sharded leaves are not host-addressable;
                # allgather them (a collective — all processes participate),
                # then exactly one process writes the files.
                save_state = state
                if jax.process_count() > 1:
                    from jax.experimental import multihost_utils as mh

                    save_state = TrainState(
                        state.params, state.opt_state,
                        mh.process_allgather(state.emb, tiled=True),
                        jax.tree_util.tree_map(
                            lambda x: mh.process_allgather(x, tiled=True)
                            if getattr(x, "ndim", 0) >= 1 and x.shape[0] == n_padded
                            else x,
                            state.emb_opt_state,
                        ),
                        state.epoch,
                    )
                if jax.process_index() == 0:
                    ckpt_util.save_checkpoint(
                        checkpoint_dir, epoch, save_state.params,
                        save_state.emb[:n_blocks],
                        meta={
                            "ch": model_cfg.ch,
                            "chanstr": model_cfg.chanstr,
                            "seed_tag": model_cfg.seed_tag,
                            "entropy_mode": model_cfg.entropy_mode,
                            "ctx_hidden": getattr(model_cfg, "ctx_hidden", 8),
                            "ctx_tail": getattr(model_cfg, "ctx_tail", 0),
                        },
                    )
                    ckpt_util.save_train_state(checkpoint_dir, epoch, save_state)
        epoch = e1 + 1

    # strip mesh padding from the returned embeddings (callers see real blocks)
    state = TrainState(
        state.params, state.opt_state, state.emb[:n_blocks], state.emb_opt_state,
        state.epoch,
    )
    return spec, state
