"""Multi-host (multi-process) block-DP dry run on CPU.

Validates the multi-process path on one machine: N processes, each with
``local_devices`` virtual CPU devices, join through ``jax.distributed`` and
run one sharded training step over the global 1-D block mesh — the same
``nvfpcc_tpu.parallel.mesh`` + ``train.loop`` code a multi-host GPU cluster
runs.

Every process loads identical grids (on a cluster: every host reads the same
cloud and builds the same artifacts — grids are deterministic), places them
with ``jax.device_put`` onto the global NamedSharding, and runs the jitted
epoch in SPMD lockstep. Checkpoint writes happen on process 0 only
(``train/loop.py``), after a ``process_allgather`` of the block-sharded
leaves.

Usage (parent spawns the workers):
    python scripts/multihost_dryrun.py [--processes 2] [--local_devices 4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def worker(args) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nvfpcc_tpu.parallel import mesh as pm

    n_proc = pm.init_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.processes,
        process_id=args.process_id,
    )
    assert n_proc == args.processes, (n_proc, args.processes)
    n_dev = len(jax.devices())
    assert n_dev == args.processes * args.local_devices, n_dev

    import numpy as np

    from nvfpcc_tpu.config import ModelConfig, TrainConfig
    from nvfpcc_tpu.train.loop import train

    rng = np.random.default_rng(0)  # identical data on every process
    n_blocks = n_dev + 3  # exercise the padding/mask path
    gt = (rng.uniform(0, 1, (n_blocks, 32, 32, 32)) < 0.02).astype(np.uint8)
    dist = (rng.uniform(0, 5, gt.shape) * (1 - gt)).astype(np.float32)

    mesh = pm.make_mesh()
    assert mesh.devices.size == n_dev
    spec, state = train(
        gt,
        dist,
        ModelConfig(ch=2, chanstr="4,8,4,4"),
        TrainConfig(epochs=2, phase_change=1, batch_size=4, eval_every=1),
        log=(print if args.process_id == 0 else lambda *_: None),
        mesh=mesh,
        checkpoint_dir=args.ckpt_dir,
    )
    kernel = np.asarray(state.params["decoder"]["up0"]["kernel"])  # replicated
    assert np.isfinite(kernel).all()
    if args.process_id == 0:
        import glob

        snaps = glob.glob(os.path.join(args.ckpt_dir, "*"))
        assert snaps, "process 0 wrote no checkpoints"
        print(
            f"multihost_dryrun: OK — {args.processes} processes x "
            f"{args.local_devices} devices, sharded train step + checkpoint"
        )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local_devices", type=int, default=4)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--ckpt_dir", default=None)
    args = ap.parse_args()

    if args.process_id is not None:
        worker(args)
        return 0

    # parent: spawn one subprocess per simulated host
    port = 8476
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="nvfpcc_mh_")
    procs = []
    for pid in range(args.processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, os.path.abspath(__file__),
                    "--processes", str(args.processes),
                    "--local_devices", str(args.local_devices),
                    "--coordinator", f"localhost:{port}",
                    "--process_id", str(pid),
                    "--ckpt_dir", ckpt_dir,
                ],
            )
        )
    codes = [p.wait(timeout=1800) for p in procs]
    if any(codes):
        print(f"multihost_dryrun FAILED: exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
