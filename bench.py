"""Headline benchmark: steady-state training-epoch wall-clock at the flagship
configuration (longdress_vox10 scale: 917 leaf blocks of 32^3, batch 16,
per-batch net updates + the full-set embedding update).

Prints ONE JSON line: {"metric", "value", "unit"} plus secondary keys
"encode_ms"/"decode_ms" — warm-path codec latency at the same scale (the
pipeline is train+encode+decode; the epoch number alone hides where
encode/decode time goes) — and the device it ran on ("platform",
"device_kind", "device_count"). It measures a GPU only: with no GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

N_BLOCKS = 917
WARMUP_EPOCHS = 1
TIMED_CHUNKS = 3
EPOCHS_PER_DISPATCH = 10  # production cadence: one program per eval interval


def synthetic_flagship_grids(seed: int = 0):
    """917 blocks of STRUCTURED occupancy: a curved surface shell crossing
    each block (~3% occupied, like a real vox10 leaf block), with the
    distance grid the unsigned distance to that shell — spatially coherent,
    matching what training consumes. (Round-3 bench used iid 3% noise:
    shape-faithful but occupancy-unfaithful, so a sparsity-sensitive
    regression could not have shown up; flagged in the round-3 review.)"""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((N_BLOCKS, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    anchor = rng.uniform(10.0, 22.0, (N_BLOCKS, 3))
    phase = rng.uniform(0, 2 * np.pi, (N_BLOCKS, 1, 1, 1))
    g = (np.arange(32) + 0.5).astype(np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([zz, yy, xx], -1)[None]  # (1,32,32,32,3)
    rel = coords - anchor[:, None, None, None, :]
    # signed distance to a gently-bowed plane; |grad| ~ 1 keeps the shell
    # one voxel thick (~32^2/32^3 ~ 3% occupancy)
    sd = (rel * nrm[:, None, None, None, :]).sum(-1)
    sd = sd + 2.0 * np.sin(0.12 * rel[..., 0] + phase) * np.cos(0.09 * rel[..., 1])
    gt = (np.abs(sd) < 0.52).astype(np.uint8)
    dist = np.maximum(np.abs(sd) - 0.52, 0.0).astype(np.float32) * (1 - gt)
    return gt, dist


def main() -> None:
    from nvfpcc_tpu.config import ModelConfig, TrainConfig
    from nvfpcc_tpu.models import decoder as M
    from nvfpcc_tpu.train import loop as T
    from nvfpcc_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    enable_compilation_cache()

    gt, dist = synthetic_flagship_grids()
    mcfg = ModelConfig()  # ch=3, chanstr 8,16,8,8 (flagship)
    cfg = TrainConfig(batch_size=16)

    spec = M.build_model_spec(mcfg.ch, mcfg.channels, mcfg.seed_tag)
    params = M.init_params(spec)
    emb = M.init_embeddings(N_BLOCKS, mcfg.ch)
    steps_per_epoch = -(-N_BLOCKS // cfg.batch_size)
    net_opt, emb_opt = T.make_optimizers(cfg, steps_per_epoch)
    opt_state = net_opt.init(params)
    emb_opt_state = emb_opt.init(emb)
    n_total_pts = float(gt.sum())
    gt_d, dist_d = T._prep_dense(gt, dist)
    block_valid = jnp.ones((N_BLOCKS,), jnp.float32)

    # the production train() dispatch unit: a chunk of EPOCHS_PER_DISPATCH
    # epochs (the eval cadence) scanned inside ONE program
    # (train/loop.py:make_epochs_fn)
    epochs_fn = T.make_epochs_fn(spec, cfg, net_opt, emb_opt, n_total_pts, q=2)
    idx, mask = T.batch_plan(N_BLOCKS, cfg.batch_size, cfg.shuffle, cfg.seed, 0)
    k = EPOCHS_PER_DISPATCH
    idx_d = jnp.asarray(np.broadcast_to(idx, (k,) + idx.shape))
    mask_d = jnp.asarray(np.broadcast_to(mask, (k,) + mask.shape))
    base_key = jax.random.PRNGKey(0)
    epoch_nums = jnp.arange(k, dtype=jnp.int32)

    rd_w = T.rd_weights(cfg)

    def run_chunk(state):
        params, opt_state, emb, emb_opt_state = state
        out = epochs_fn(
            params, opt_state, emb, emb_opt_state, gt_d, dist_d, idx_d, mask_d,
            block_valid, base_key, epoch_nums, rd_w,
        )
        return out[:4], out[4]

    state = (params, opt_state, emb, emb_opt_state)
    for _ in range(WARMUP_EPOCHS):
        state, metrics = run_chunk(state)
    jax.block_until_ready(state)

    t0 = time.perf_counter()
    for _ in range(TIMED_CHUNKS):
        state, metrics = run_chunk(state)
    jax.block_until_ready(state)
    epoch_ms = (time.perf_counter() - t0) / (TIMED_CHUNKS * k) * 1000.0

    encode_ms, decode_ms = codec_latency(mcfg, state[0], np.asarray(state[2]))

    print(
        json.dumps(
            {
                "metric": "train_epoch_flagship",
                "value": round(epoch_ms, 2),
                "unit": "ms",
                "epochs_per_dispatch": EPOCHS_PER_DISPATCH,
                "encode_ms": round(encode_ms, 2),
                "decode_ms": round(decode_ms, 2),
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
            }
        )
    )


def synthetic_origins(n_blocks: int, depth: int = 10, level: int = 5, seed: int = 1):
    """n_blocks distinct leaf origins in canonical traversal order."""
    from nvfpcc_tpu.octree.partition import leaf_origins

    rng = np.random.default_rng(seed)
    block = 1 << (depth - level)
    pts = rng.integers(0, 1 << level, (4 * n_blocks, 3)) * block
    origins = leaf_origins(pts.astype(np.int64), depth, level)
    if len(origins) < n_blocks:
        raise RuntimeError("synthetic origin pool too small")
    return origins[:n_blocks]


def codec_latency(mcfg, params, emb):
    """(encode_ms, decode_ms) on the warm path (second call each; the first
    pays compile, absorbed by the persistent cache across runs)."""
    from nvfpcc_tpu import codec
    from nvfpcc_tpu.config import CodecConfig

    ccfg = CodecConfig()
    origins = synthetic_origins(emb.shape[0], ccfg.depth, ccfg.level)
    n_pts = 875_031  # flagship-scale source point count (bpp denominator only)

    def enc():
        return codec.encode(params, emb, origins, mcfg, ccfg, n_pts)

    result = enc()  # warm-up: compiles/caches the shared recon program
    pack = result.pack
    codec.decode(pack)
    t0 = time.perf_counter()
    result = enc()
    encode_ms = (time.perf_counter() - t0) * 1000.0
    t0 = time.perf_counter()
    codec.decode(result.pack)
    decode_ms = (time.perf_counter() - t0) * 1000.0
    return encode_ms, decode_ms


if __name__ == "__main__":
    main()
