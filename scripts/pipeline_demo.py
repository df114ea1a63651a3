"""One-process full-pipeline run: grids -> train(501) -> encode -> decode,
per-stage wall-clock, in a single warm process.

All stages run through the real CLI entry points (``nvfpcc_tpu.cli.main``),
sharing one jax runtime, the module-level codec jit cache, and the
persistent XLA compile cache — the production serving posture
(``nvfpcc_tpu.serve``) expressed as one measured run. Parity (rc_enc ==
rc_dec) and D1 PSNR against the source are verified at the end.

Usage:
    python scripts/pipeline_demo.py [--cloud path.ply] [--epochs 501]
        [--entropy_mode channel|ctx|...] [--thh 0.65] [--out stats.json]

With no --cloud, the deterministic vox10-scale bumpy sphere
(scripts/synth_cloud.py, radius 0.213 ~ longdress scale) is generated.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cloud", default=None)
    ap.add_argument("--epochs", type=int, default=501)
    ap.add_argument("--entropy_mode", default="channel")
    ap.add_argument("--ctx_detach_pred", action="store_true")
    ap.add_argument("--lambda", dest="lmbda", type=float, default=200.0)
    ap.add_argument("--thh", type=float, default=0.65)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write the stage stats JSON here")
    args = ap.parse_args()

    from nvfpcc_tpu.cli import main as cli_main
    from nvfpcc_tpu.utils.cache import enable_compilation_cache, enable_hang_diagnostics

    enable_compilation_cache()
    enable_hang_diagnostics()

    work = args.workdir or tempfile.mkdtemp(prefix="nvfpcc_pipeline_")
    os.makedirs(work, exist_ok=True)
    stages: dict = {}
    t_all = time.perf_counter()

    cloud = args.cloud
    if cloud is None:
        from scripts.synth_cloud import bumpy_sphere_cloud
        from nvfpcc_tpu.io.ply import write_ply_points

        t0 = time.perf_counter()
        pts = bumpy_sphere_cloud(depth=args.depth, radius=0.213)
        cloud = os.path.join(work, "sphere_vox10.ply")
        write_ply_points(cloud, pts, ascii=False)
        stages["synth_cloud_s"] = round(time.perf_counter() - t0, 2)
        print(f"[pipeline] synthesized {len(pts)} pts -> {cloud}", flush=True)

    common = ["--depth", str(args.depth), "--level", str(args.level)]

    def stage(name: str, argv: list) -> None:
        t0 = time.perf_counter()
        status = cli_main(argv)
        if status:
            raise SystemExit(f"stage {name} failed with {status}")
        stages[f"{name}_s"] = round(time.perf_counter() - t0, 2)
        print(f"[pipeline] {name}: {stages[f'{name}_s']} s", flush=True)

    ckpt = os.path.join(work, "ckpts")
    pack = os.path.join(work, "pack.pk")
    rc_enc = os.path.join(work, "rc_enc.ply")
    rc_dec = os.path.join(work, "rc_dec.ply")

    stage("grids", ["grids", cloud, *common])
    stage(
        "train",
        [
            "train", cloud, *common, "--epochs", str(args.epochs),
            "--lambda", str(args.lmbda), "--entropy_mode", args.entropy_mode,
            "--checkpoint_dir", ckpt,
            *(["--ctx_detach_pred"] if args.ctx_detach_pred else []),
        ],
    )
    stage(
        "encode",
        [
            "encode", cloud, *common, "--load_checkpoint", ckpt,
            "--entropy_mode", args.entropy_mode, "--pack_fn", pack,
            "--recon", rc_enc, "--thh", str(args.thh),
        ],
    )
    stage("decode", ["decode", pack, "--recon", rc_dec])

    stages["total_s"] = round(time.perf_counter() - t_all, 2)

    from nvfpcc_tpu.io.ply import read_ply_points

    a, b = read_ply_points(rc_enc), read_ply_points(rc_dec)
    parity = a.shape == b.shape and bool(np.array_equal(a, b))
    stages["parity"] = parity
    stages["n_points_rec"] = int(len(b))

    from nvfpcc_tpu.metrics import d1_psnr, d2_psnr

    src = np.rint(read_ply_points(cloud)).astype(np.int64)
    rec = np.rint(b).astype(np.int64)
    m = d1_psnr(src, rec, depth=args.depth)
    stages["d1_psnr"] = round(float(m["psnr"]), 4)
    m2 = d2_psnr(src, rec, depth=args.depth)
    stages["d2_psnr"] = round(float(m2["psnr"]), 4)
    stages["pack_bytes"] = os.path.getsize(pack)
    stages["bpp"] = round(8.0 * stages["pack_bytes"] / len(src), 4)
    stages["entropy_mode"] = args.entropy_mode
    stages["epochs"] = args.epochs
    stages["lambda"] = args.lmbda

    line = json.dumps(stages)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not parity:
        print("[pipeline] PARITY FAIL", file=sys.stderr)
        return 1
    print(f"[pipeline] total {stages['total_s']} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
