"""Decompose the training-epoch wall-clock on the device.

Times, at flagship scale (964 blocks), steady state:
  - full epoch (per-batch scan + full-set emb update)
  - per-batch scan only
  - full-set update only
  - eval forward only
  - decode reconstruction (batched forward, q=2)
across batch sizes, printing a table.
"""

from __future__ import annotations

import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=5):
    jax.block_until_ready(fn(*args))  # compile + warm
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / n


def main() -> None:
    from nvfpcc_tpu.config import ModelConfig, TrainConfig
    from nvfpcc_tpu.models import decoder as M
    from nvfpcc_tpu.train import loop as T
    from nvfpcc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 964
    rng = np.random.default_rng(0)
    gt = (rng.uniform(0, 1, (n_blocks, 32, 32, 32)) < 0.03).astype(np.uint8)
    dist = (rng.uniform(0, 8, gt.shape) * (1 - gt)).astype(np.float32)
    mcfg = ModelConfig()
    spec = M.build_model_spec(mcfg.ch, mcfg.channels, mcfg.seed_tag)
    params = M.init_params(spec)
    emb = M.init_embeddings(n_blocks, mcfg.ch)
    gt_d, dist_d = T._prep_dense(gt, dist)
    block_valid = jnp.ones((n_blocks,), jnp.float32)
    key = jax.random.PRNGKey(0)
    n_total = float(gt.sum())

    dev = jax.devices()[0]
    print(f"n_blocks={n_blocks} platform={dev.platform} device_kind={dev.device_kind}")

    # eval forward (all blocks)
    eval_fwd = jax.jit(lambda p, e: M.net_apply(spec, p, e, "eval", 2)[0])
    t = timeit(eval_fwd, params, emb)
    print(f"eval fwd  (all {n_blocks}):      {t*1000:8.1f} ms  ({n_blocks/t:,.0f} blocks/s)")

    # decode reconstruction path (q=2, aux-free)
    recon = jax.jit(lambda p, l: M.reconstruct(spec, p, l, q=2))
    lat = jnp.zeros((n_blocks,) + spec.latent_shape, jnp.float32)
    t = timeit(recon, params, lat)
    print(f"recon     (all {n_blocks}):      {t*1000:8.1f} ms  ({n_blocks/t:,.0f} blocks/s)")

    for bs in (16, 64, 256):
        cfg = TrainConfig(batch_size=bs)
        net_opt, emb_opt = T.make_optimizers(cfg, -(-n_blocks // bs))
        opt_state = net_opt.init(params)
        emb_opt_state = emb_opt.init(emb)
        idx, mask = T.batch_plan(n_blocks, bs, cfg.shuffle, cfg.seed, 0)
        idx_d, mask_d = jnp.asarray(idx), jnp.asarray(mask)
        rd_w = T.rd_weights(cfg)
        epoch_fn = T.make_epoch_fn(spec, cfg, net_opt, emb_opt, n_total, q=2)

        def full(params=params, opt_state=opt_state, emb=emb,
                 emb_opt_state=emb_opt_state, idx_d=idx_d, mask_d=mask_d,
                 epoch_fn=epoch_fn):
            # donation invalidates inputs; copy so we can re-time
            return epoch_fn(
                jax.tree_util.tree_map(jnp.copy, params),
                jax.tree_util.tree_map(jnp.copy, opt_state),
                jnp.copy(emb),
                jax.tree_util.tree_map(jnp.copy, emb_opt_state),
                gt_d, dist_d, idx_d, mask_d, block_valid, key, rd_w,
            )

        t = timeit(full, n=3)
        n_steps = idx.shape[0]
        print(
            f"epoch B={bs:<4d} ({n_steps:3d} steps): {t*1000:8.1f} ms  "
            f"({t*1000/n_steps:6.2f} ms/step incl full-set update)"
        )


if __name__ == "__main__":
    main()
