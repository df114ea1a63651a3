"""Encode+decode+parity+D1 from an existing checkpoint (no retraining).

Usage: python scripts/encode_eval.py cloud.ply --ckpt DIR --entropy_mode M
       [--depth 10 --level 5 --thh 0.65] [--out stats.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cloud")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--entropy_mode", default="channel")
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--thh", type=float, default=0.65)
    ap.add_argument("--ctx_post", action="store_true")
    ap.add_argument("--ctx_hidden", type=int, default=8)
    ap.add_argument("--ctx_fit_steps", type=int, default=3000)
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--no_d2", action="store_true",
        help="skip the point-to-plane (D2) metric (it adds ~a minute of host "
        "work per million points)",
    )
    args = ap.parse_args()

    from nvfpcc_tpu.cli import main as cli_main
    from nvfpcc_tpu.io.ply import read_ply_points
    from nvfpcc_tpu.metrics import d1_psnr, d2_psnr
    from nvfpcc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    work = os.path.dirname(os.path.abspath(args.ckpt.rstrip("/")))
    pack = os.path.join(work, "pack.pk")
    rc_enc = os.path.join(work, "rc_enc.ply")
    rc_dec = os.path.join(work, "rc_dec.ply")
    common = ["--depth", str(args.depth), "--level", str(args.level)]
    stats = {}
    t0 = time.perf_counter()
    extra = ["--ctx_hidden", str(args.ctx_hidden)]
    if args.ctx_post:
        extra += ["--ctx_post", "--ctx_fit_steps", str(args.ctx_fit_steps)]
    rc = cli_main(["encode", args.cloud, *common, "--load_checkpoint", args.ckpt,
                   "--entropy_mode", args.entropy_mode, "--pack_fn", pack,
                   "--recon", rc_enc, "--thh", str(args.thh), *extra])
    if rc:
        # do NOT fall through to stale pack/rc_*.ply files from a previous run
        raise SystemExit(f"encode stage failed with status {rc}")
    stats["encode_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    rc = cli_main(["decode", pack, "--recon", rc_dec])
    if rc:
        raise SystemExit(f"decode stage failed with status {rc}")
    stats["decode_s"] = round(time.perf_counter() - t0, 2)
    a, b = read_ply_points(rc_enc), read_ply_points(rc_dec)
    stats["parity"] = a.shape == b.shape and bool(np.array_equal(a, b))
    stats["n_points_rec"] = int(len(b))
    src = np.rint(read_ply_points(args.cloud)).astype(np.int64)
    rec = np.rint(b).astype(np.int64)
    m = d1_psnr(src, rec, depth=args.depth)
    stats["d1_psnr"] = round(float(m["psnr"]), 4)
    if not args.no_d2:
        m2 = d2_psnr(src, rec, depth=args.depth)
        stats["d2_psnr"] = round(float(m2["psnr"]), 4)
    stats["pack_bytes"] = os.path.getsize(pack)
    stats["bpp"] = round(8.0 * stats["pack_bytes"] / len(src), 4)
    stats["entropy_mode"] = args.entropy_mode
    from nvfpcc_tpu import codec as _codec

    pk = _codec.load_pack(pack)
    stats["b_latent_stream"] = round(
        8.0 * len(pk["latent_pack"]["stream"]) / len(src), 4
    )
    if "ctx_hidden" in pk["model"]:
        stats["ctx_hidden"] = int(pk["model"]["ctx_hidden"])
    stats["ctx_post"] = bool(args.ctx_post)
    line = json.dumps(stats)
    print(line, flush=True)
    if args.out:
        open(args.out, "w").write(line + "\n")
    return 0 if stats["parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
