"""Block-data-parallel sharding over a device mesh.

The reference is single-process single-GPU (SURVEY §2.4); the scaling axis
here is the octree's leaf-block dimension: all N blocks are
independent given the shared decoder, so

- per-block arrays (embeddings, gt/dist grids, their Adam moments) shard
  along axis 0 of a 1-D ``blocks`` mesh,
- the shared decoder params (and their optimizer state) replicate,
- under ``jit`` XLA/GSPMD inserts the psum for the decoder grads and the
  gathers for batched indexing — no hand-written collectives.

NamedSharding needs the block axis divisible by the mesh, so callers pad the
leaf set up to a multiple (:func:`pad_blocks`) and mask the padding rows in
the loss (``nvfpcc_tpu.train.losses`` block masks).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize multi-process (multi-host) jax if requested.

    Pass the three arguments explicitly (coordinator ``host:port``, process
    count, this process's id), as ``scripts/multihost_dryrun.py`` does: a
    plain GPU host has no cluster environment to auto-detect them from. Returns ``jax.process_count()``. Safe to call when
    already initialized or single-process (no-op).
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except RuntimeError as e:  # already initialized
            if "already" not in str(e).lower():
                raise
    return jax.process_count()


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Block-DP mesh over all (or the given) devices, axis ``blocks``.

    Multi-host aware: with >1 process and no explicit device list, the global
    device array is laid out (hosts, local_chips) and flattened host-major,
    so each host's contiguous slice of the block axis lands on its own
    devices — the per-host grid/embedding data a host feeds stays on its local
    interconnect and only the decoder-grad psum crosses hosts (the cheapest
    possible multi-host traffic pattern for this model: ~51k params per
    step). The mesh is 1-D: block-DP needs no topology beyond that.
    """
    if devices is None:
        if jax.process_count() > 1:
            devs = sorted(
                jax.devices(), key=lambda d: (d.process_index, getattr(d, "id", 0))
            )
            return Mesh(np.asarray(devs), (BLOCK_AXIS,))
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def padded_block_count(n_blocks: int, mesh: Mesh) -> int:
    d = mesh.devices.size
    return -(-n_blocks // d) * d


def pad_blocks(arr: np.ndarray, n_padded: int) -> np.ndarray:
    """Zero-pad axis 0 up to ``n_padded`` rows (host)."""
    n = arr.shape[0]
    if n == n_padded:
        return arr
    pad = np.zeros((n_padded - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def block_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BLOCK_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def replicate(mesh: Mesh, tree):
    """Replicate every leaf of a pytree across the mesh."""
    s = replicated_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def shard_block_tree(mesh: Mesh, tree, n_padded: int):
    """Shard leaves whose axis 0 is the (padded) block axis; replicate the
    rest (e.g. Adam's scalar step count)."""
    bs = block_sharding(mesh)
    rs = replicated_sharding(mesh)

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == n_padded:
            return jax.device_put(x, bs)
        return jax.device_put(x, rs)

    return jax.tree_util.tree_map(place, tree)


def shard_train_arrays(
    mesh: Mesh, params, opt_state, emb, emb_opt_state, gt, dist
) -> Tuple:
    """Lay out the training state for block-DP (see module docstring).

    ``emb``/``gt``/``dist`` (and the matching emb-Adam moments) must already
    be padded to a multiple of the mesh size (:func:`pad_blocks`).
    """
    n_padded = int(emb.shape[0])
    if n_padded % mesh.devices.size != 0:
        raise ValueError(
            f"block axis {n_padded} not divisible by mesh size {mesh.devices.size}; "
            "pad with pad_blocks first"
        )
    bs = block_sharding(mesh)
    return (
        replicate(mesh, params),
        replicate(mesh, opt_state),
        jax.device_put(emb, bs),
        shard_block_tree(mesh, emb_opt_state, n_padded),
        jax.device_put(gt, bs),
        jax.device_put(dist, bs),
    )
