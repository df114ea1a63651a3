"""End-to-end smoke of the codec on one NVIDIA GPU.

Runs the main path — grids -> train -> encode -> decode -> eval — through the
user entry points (``nvfpcc_tpu.cli``) at the flagship width (ch=3, chanstr
8,16,8,8, level 5 -> 32^3 blocks, batch 16) on the deterministic vox10 bumpy
sphere (``scripts/synth_cloud.py``, radius 0.213: ~875k points, 964 leaf
blocks), and checks each stage against the repository's plain references:

1. grids   — device grids equal the CPU XLA grids exactly (``gt`` and the
             integer squared distances); the brute-force probes pass.
2. train   — channel mode, bf16 compute, one q=1 epoch then q=2 epochs.
3. parity  — f32 and bf16 packs, each decoded by ``cli decode`` in a fresh
             process with an emptied compile cache: rc_enc == rc_dec, and
             the reconstruction holds >= 10,000 points.
4. ctx     — a ctx-mode checkpoint encoded with ``--ctx_post`` (the
             post-hoc predictor fit on the GPU), decoded fresh: parity.
5. eval    — ``cli eval`` (D1) on the GPU; the device's per-point squared
             NN distances equal chunked brute force on sampled points.
6. numerics — the f32 pack's occupancy on the GPU against the CPU: max
             |dp| and the share of occupied voxels whose ``> thh`` decision
             flips (gate: <= 1%), at the default precision and at "highest".

Each phase runs in its own child process, one at a time; this parent never
initializes a GPU backend (a JAX process reserves most of the card's memory
when it starts). A failed phase ends the run with a non-zero exit. With no
GPU the script fails before any phase. The last line of stdout is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

``--four`` runs only the four-GPU check instead: block-DP training
(``train --mesh``, ``parallel/mesh.py``) over four cards against the same
training on one card, both in f32 under ``jax.default_matmul_precision
("highest")`` and q=1: per-epoch loss, and each parameter leaf's update
direction (see ``FOUR_MIN_UPDATE_COSINE`` for why not elementwise equality).

Usage:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
BUDGET_S = 1150.0  # whole run, compiles included

# flagship cloud and model (README quick start)
DEPTH, LEVEL = 10, 5
SPHERE_RADIUS = 0.213
MODEL = ["--ch", "3", "--chanstr", "8,16,8,8"]
# one q=1 epoch, then q=2; chunks [0] [1..10] [11..20]: epochs 11-20 rerun
# the compiled q=2 chunk, so their time is the steady epoch time
TRAIN = ["--epochs", "21", "--phase_change", "1", "--eval_every", "10", "--batchsize", "16"]
CTX_TRAIN = ["--epochs", "11", "--phase_change", "1", "--eval_every", "10", "--batchsize", "16"]
CTX_FIT_STEPS = "250"
MIN_POINTS = 10_000
TARGET_POINTS = 50_000  # the smoke's --thh keeps about this many voxels
D1_SAMPLES = 1000
D1_RADIUS = 63  # metrics.d1 default
MAX_FLIP_SHARE = 0.01

# --four: q=1 epochs only. At q=2 a last-bit difference between the two
# layouts can flip a weight residual's rounding to the 1/16 grid, a discrete
# jump that no tolerance bounds; q=1 compares the sharding and nothing else.
# Chunks [0] [1]: epoch 1 reruns the compiled epoch-0 program, so its time
# is the steady epoch time.
FOUR_EPOCHS = 2
# Final params and embeddings, 4 GPUs vs 1. Elementwise equality at the CPU
# test's tolerance (tests/test_parallel.py: rtol 2e-4, atol 2e-6) is printed
# but cannot be the gate on the card: the conv gradients sum in another order
# on 4 H100s than on one, and Adam's first steps move every element by +-lr
# whatever its gradient's size, so an element whose gradient is at float-noise
# level steps the other way in the other layout (measured on 4 H100s: 1.35e-3
# apart in a bias after 244 steps, 1.04e-2 in an embedding after 2 epochs,
# while the per-epoch loss agreed to all 5 printed digits). The gate is
# therefore the loss trajectory plus the direction of each leaf's update from
# its initial value: a sharding fault (a block dropped or counted twice,
# padding unmasked) changes the loss and sends the updates elsewhere.
FOUR_LOSS_RTOL = 1e-3
FOUR_MIN_UPDATE_COSINE = 0.9


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def path(name: str) -> str:
    return os.path.join(WORK, name)


CLOUD = "sphere_vox10.ply"


# ---------------------------------------------------------------- devices


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def require_gpu(dev: dict, count: int = 1) -> None:
    """Refuse anything but ``count`` or more NVIDIA GPUs."""
    if dev.get("platform") != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.get('platform')!r}"
        )
    if dev.get("count", 0) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found {dev.get('count')}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise SmokeFailure("nvidia-smi reported no GPU")
    return out


# ---------------------------------------------------------------- helpers


def cli(argv: list) -> list:
    """Run one ``nvfpcc_tpu.cli`` command in this process; echo and return
    its stdout lines."""
    from nvfpcc_tpu.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        status = main(argv)
    dt = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print("    " + line, flush=True)
    print(f"  cli {argv[0]}: {dt:.2f} s", flush=True)
    if status:
        raise SmokeFailure(f"cli {argv[0]} exited {status}")
    return lines


def read_points(name: str):
    import numpy as np

    from nvfpcc_tpu.io.ply import read_ply_points

    return np.rint(read_ply_points(path(name))).astype(np.int64)


def steady_epoch_s(lines: list, first: int, last: int) -> float:
    """The per-epoch time train() logs for epochs ``first..last`` (one
    chunk, so one value)."""
    times = set()
    for line in lines:
        m = re.match(r"\[Epoch (\d+) TRAIN ([0-9.]+)s\]", line)
        if m and first <= int(m.group(1)) <= last:
            times.add(float(m.group(2)))
    if len(times) != 1:
        raise SmokeFailure(f"no single chunk time for epochs {first}-{last}: {times}")
    return times.pop()


def threshold_for(ckpt_dir: str, n_voxels: int) -> float:
    """A ``--thh`` that the checkpoint's quantized reconstruction exceeds at
    about ``n_voxels`` voxels (a short train leaves every voxel below the
    production 0.65, and the smoke needs a real point set)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nvfpcc_tpu import codec
    from nvfpcc_tpu.config import ModelConfig
    from nvfpcc_tpu.models import decoder as M
    from nvfpcc_tpu.utils import checkpoint as C

    params, emb, meta = C.load_checkpoint_meta(C.latest_checkpoint(ckpt_dir))
    mcfg = ModelConfig(chanstr=meta["chanstr"])
    spec = M.build_model_spec(
        int(meta["ch"]), mcfg.channels, meta["seed_tag"], meta["entropy_mode"],
        ctx_hidden=int(meta["ctx_hidden"]), ctx_tail=int(meta["ctx_tail"]),
    )
    qparams = codec.quantize_residuals(params, 16)
    code = jax.jit(lambda p, e: M.get_latent_code(spec, p, e))(qparams, jnp.asarray(emb))
    lat = np.rint(np.asarray(code["quantized_latent"], np.float64)).astype(np.float32)
    occ = codec.reconstruct_all(spec, codec.unpack_weights(codec.pack_weights(qparams, 16)), lat)
    v = float(np.partition(occ.ravel(), -n_voxels)[-n_voxels])
    return math.floor(v * 1e4) / 1e4


def encode(ckpt: str, tag: str, thh: float, extra: list) -> int:
    lines = cli([
        "encode", path(CLOUD), "--depth", str(DEPTH), "--level", str(LEVEL),
        "--load_checkpoint", ckpt, "--pack_fn", path(f"pack_{tag}.pk"),
        "--recon", path(f"rc_enc_{tag}.ply"), "--thh", f"{thh}", *extra,
    ])
    n = len(read_points(f"rc_enc_{tag}.ply"))
    stats = next(line for line in lines if " bpp " in line)
    print(f"  encode {tag}: thh {thh}, {n} reconstructed points | {stats}", flush=True)
    return n


# ---------------------------------------------------------------- phases


def phase_grids() -> None:
    import numpy as np

    from nvfpcc_tpu.cli import artifact_path
    from nvfpcc_tpu.grids.builder import build_block_grids, validate_dist_grids
    from nvfpcc_tpu.io.ply import write_ply_points
    from scripts.synth_cloud import bumpy_sphere_cloud

    t0 = time.perf_counter()
    pts = bumpy_sphere_cloud(depth=DEPTH, radius=SPHERE_RADIUS)
    write_ply_points(path(CLOUD), pts, ascii=False)
    print(f"  cloud: {len(pts)} points in {time.perf_counter() - t0:.2f} s", flush=True)

    cli(["grids", path(CLOUD), "--depth", str(DEPTH), "--level", str(LEVEL)])
    art = np.load(artifact_path(path(CLOUD), DEPTH, LEVEL))
    origins, gt, dist = art["origins"], art["gt"], art["dist"]
    print(f"  device grids: {len(origins)} blocks, {int(gt.sum())} occupied voxels", flush=True)

    t0 = time.perf_counter()
    gt_cpu, dist_cpu = build_block_grids(pts, origins, 1 << (DEPTH - LEVEL), platform="cpu")
    print(f"  CPU XLA grids: {time.perf_counter() - t0:.2f} s", flush=True)
    check(np.array_equal(gt, gt_cpu), "device gt == CPU gt")
    sq = np.rint(dist.astype(np.float64) ** 2)
    sq_cpu = np.rint(dist_cpu.astype(np.float64) ** 2)
    check(np.array_equal(sq, sq_cpu), "device round(dist^2) == CPU round(dist^2), exactly")
    print(f"  dist bitwise equal: {np.array_equal(dist, dist_cpu)} (sqrt may differ by 1 ulp)")
    # the CLI build already ran the default 256 probes (seed 0); 256 more
    validate_dist_grids(pts, origins, dist, 1 << (DEPTH - LEVEL), seed=1)
    check(True, "2 x 256 brute-force probes of the device distance grid")


def phase_fit() -> None:
    """Train channel + ctx checkpoints and write the f32, bf16 and ctx_post
    packs (one process: the convs autotune once)."""
    common = ["--depth", str(DEPTH), "--level", str(LEVEL), *MODEL]

    lines = cli([
        "train", path(CLOUD), *common, *TRAIN, "--entropy_mode", "channel",
        "--checkpoint_dir", path("ckpt"),
    ])
    check(any(re.match(r"\[Epoch 0000 TRAIN", l) for l in lines), "q=1 epoch ran")
    check(any(re.match(r"\[Epoch 0020 TRAIN", l) for l in lines), "q=2 epochs ran")
    print(f"  steady epoch (q=2, bf16, B=16): {steady_epoch_s(lines, 11, 20):.3f} s", flush=True)

    thh = threshold_for(path("ckpt"), TARGET_POINTS)
    n = encode(path("ckpt"), "f32", thh, ["--entropy_mode", "channel"])
    check(n >= MIN_POINTS, f"f32 reconstruction holds {n} >= {MIN_POINTS} points")
    n = encode(path("ckpt"), "bf16", thh, ["--entropy_mode", "channel", "--recon_dtype", "bf16"])
    check(n >= MIN_POINTS, f"bf16 reconstruction holds {n} >= {MIN_POINTS} points")

    cli([
        "train", path(CLOUD), *common, *CTX_TRAIN, "--entropy_mode", "ctx",
        "--checkpoint_dir", path("ckpt_ctx"),
    ])
    thh = threshold_for(path("ckpt_ctx"), TARGET_POINTS)
    n = encode(path("ckpt_ctx"), "ctx", thh, [
        "--entropy_mode", "ctx_ar", "--ctx_hidden", "32", "--ctx_tail", "24",
        "--ctx_post", "--ctx_fit_steps", CTX_FIT_STEPS,
    ])
    check(n >= MIN_POINTS, f"ctx_post reconstruction holds {n} >= {MIN_POINTS} points")


def phase_eval() -> None:
    import jax
    import numpy as np

    from nvfpcc_tpu import codec
    from nvfpcc_tpu.metrics.d1 import _nn_sq_dists

    cli(["eval", path(CLOUD), path("rc_dec_f32.ply"), "--depth", str(DEPTH)])
    src, rec = read_points(CLOUD), read_points("rc_dec_f32.ply")
    rng = np.random.default_rng(0)
    cap = D1_RADIUS * D1_RADIUS + 1
    for name, a, b in (("src->rec", src, rec), ("rec->src", rec, src)):
        got = _nn_sq_dists(a, b, D1_RADIUS, None)  # the D1 path, ambient GPU
        rows = rng.choice(len(a), min(D1_SAMPLES, len(a)), replace=False)
        want = np.full(len(rows), np.iinfo(np.int64).max)
        for c in range(0, len(b), 200_000):
            bc = b[c : c + 200_000]
            for r in range(0, len(rows), 100):
                ar = a[rows[r : r + 100]]
                d = sum((ar[:, None, k] - bc[None, :, k]) ** 2 for k in range(3))
                want[r : r + 100] = np.minimum(want[r : r + 100], d.min(1))
        check(
            np.array_equal(got[rows], np.minimum(want, cap)),
            f"D1 {name}: device squared NN distances == brute force on {len(rows)} points",
        )

    pack = codec.load_pack(path("pack_f32.pk"))
    spec, params, latents, _ = codec.decode_inputs(pack)
    thh = float(pack["codec"]["thh"])
    occ = {}
    t0 = time.perf_counter()
    occ["gpu default"] = codec.reconstruct_all(spec, params, latents)
    with jax.default_matmul_precision("highest"):
        occ["gpu highest"] = codec.reconstruct_all(spec, params, latents)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        occ["cpu"] = codec.reconstruct_all(spec, params, latents)
    print(f"  three recons: {time.perf_counter() - t0:.2f} s", flush=True)
    ref = occ["cpu"] > thh
    n_occ = int(ref.sum())
    for name in ("gpu default", "gpu highest"):
        flips = int(((occ[name] > thh) != ref).sum())
        print(
            f"  {name} vs cpu: max|dp| {float(np.abs(occ[name] - occ['cpu']).max()):.3e}, "
            f"{flips} of {n_occ} occupied voxels flip at thh {thh} "
            f"({flips / max(n_occ, 1):.3%}; {flips / ref.size:.2e} of all voxels)",
            flush=True,
        )
    same = np.array_equal(occ["gpu default"], occ["gpu highest"])
    print(f"  gpu default precision == 'highest' bitwise: {same} "
          f"({'f32' if same else 'reduced-precision (TF32)'} convs at the default)")
    flips = int(((occ["gpu default"] > thh) != ref).sum())
    check(flips <= MAX_FLIP_SHARE * n_occ, f"f32 recon flips {flips} <= 1% of {n_occ}")


def epoch_losses(lines: list) -> list:
    """Per-epoch training loss from train()'s log lines."""
    return [
        float(m.group(1))
        for m in (re.match(r"\[Epoch \d+ TRAIN [0-9.]+s\] Loss: (\S+)", l) for l in lines)
        if m
    ]


def phase_four() -> None:
    import jax
    import numpy as np

    from nvfpcc_tpu.config import ModelConfig, TrainConfig
    from nvfpcc_tpu.grids.builder import build_artifacts
    from nvfpcc_tpu.models import decoder as M
    from nvfpcc_tpu.parallel.mesh import make_mesh
    from nvfpcc_tpu.train.loop import initial_params, train
    from scripts.synth_cloud import bumpy_sphere_cloud

    require_gpu(device_info(), 4)
    devs = jax.devices()[:4]
    pts = bumpy_sphere_cloud(depth=DEPTH, radius=SPHERE_RADIUS)
    origins, gt, dist = build_artifacts(pts, DEPTH, LEVEL)
    print(f"  grids: {len(origins)} blocks", flush=True)
    cfg = TrainConfig(
        epochs=FOUR_EPOCHS, phase_change=FOUR_EPOCHS, eval_every=1, batch_size=16,
        compute_dtype="f32",
    )
    states, losses = {}, {}
    for name, mesh in (("4 GPUs", make_mesh(devs)), ("1 GPU", None)):
        lines = []
        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            spec, state = train(gt, dist, ModelConfig(), cfg, log=lines.append, mesh=mesh)
        jax.block_until_ready(state)
        epoch = steady_epoch_s(lines, FOUR_EPOCHS - 1, FOUR_EPOCHS - 1)
        losses[name] = epoch_losses(lines)
        print(f"  {name}: train {time.perf_counter() - t0:.2f} s, steady epoch "
              f"{epoch:.3f} s (f32, highest, B=16), losses {losses[name]}", flush=True)
        states[name] = state
        if mesh is not None:
            # the block axis (embedding Adam moments) is sharded over all four
            per_dev = {}
            for leaf in jax.tree_util.tree_leaves(state.emb_opt_state):
                if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == len(origins):
                    for shard in leaf.addressable_shards:
                        per_dev[shard.device] = per_dev.get(shard.device, 0) + shard.data.shape[0]
            print(f"  block rows per device: {sorted((str(d), n) for d, n in per_dev.items())}")
            check(
                len(per_dev) == 4 and len(set(per_dev.values())) == 1,
                f"{len(origins)} blocks shard evenly over 4 GPUs",
            )
    a, b = states["1 GPU"], states["4 GPUs"]
    check(
        len(losses["1 GPU"]) == FOUR_EPOCHS
        and np.allclose(losses["4 GPUs"], losses["1 GPU"], rtol=FOUR_LOSS_RTOL, atol=0),
        f"per-epoch train loss: 4 GPUs == 1 GPU at rtol {FOUR_LOSS_RTOL}",
    )
    init = initial_params(spec, ModelConfig())
    leaves = [
        (jax.tree_util.keystr(kp), np.asarray(x0), np.asarray(x), np.asarray(y))
        for (kp, x0), x, y in zip(
            jax.tree_util.tree_leaves_with_path(init),
            jax.tree_util.tree_leaves(a.params),
            jax.tree_util.tree_leaves(b.params),
        )
    ] + [("emb", np.asarray(M.init_embeddings(len(origins), spec.ch)),
          np.asarray(a.emb), np.asarray(b.emb))]
    low = []
    for name, x0, x, y in leaves:
        ux, uy = (x - x0).ravel().astype(np.float64), (y - x0).ravel().astype(np.float64)
        # a leaf neither run moved (no gradient reaches it) agrees exactly
        cos = 1.0 if np.array_equal(ux, uy) else float(
            ux @ uy / max(np.linalg.norm(ux) * np.linalg.norm(uy), 1e-30)
        )
        outside = float(np.mean(~np.isclose(y, x, rtol=2e-4, atol=2e-6)))
        print(f"    {name}: max|diff| {float(np.abs(x - y).max()):.3e}, "
              f"{outside:.1%} outside the test tolerance, update cosine {cos:.5f}")
        if cos < FOUR_MIN_UPDATE_COSINE:
            low.append(name)
    check(not low, f"every leaf's update: cosine(4 GPUs, 1 GPU) >= "
                   f"{FOUR_MIN_UPDATE_COSINE} (below: {low})")


PHASES = {"grids": phase_grids, "fit": phase_fit, "eval": phase_eval, "four": phase_four}


def run_phase(name: str) -> int:
    """Child-process body: one phase on the GPU."""
    require_gpu(device_info())
    from nvfpcc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    PHASES[name]()
    return 0


# ---------------------------------------------------------------- parent


class Runner:
    def __init__(self) -> None:
        self.t0 = time.monotonic()

    def left(self) -> float:
        return BUDGET_S - (time.monotonic() - self.t0)

    def run(self, label: str, cmd: list, env: dict | None = None) -> None:
        print(f"== {label}", flush=True)
        t0 = time.monotonic()
        try:
            p = subprocess.run(cmd, cwd=REPO, env=env, timeout=max(self.left(), 1.0))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"{label}: out of time ({BUDGET_S:.0f} s budget)")
        print(f"== {label}: rc {p.returncode}, {time.monotonic() - t0:.1f} s", flush=True)
        if p.returncode:
            raise SmokeFailure(f"{label} exited {p.returncode}")

    def phase(self, name: str) -> None:
        self.run(f"phase {name}", [sys.executable, os.path.abspath(__file__), "--phase", name])

    def fresh_decode(self, tag: str) -> None:
        """``cli decode`` in a new process whose compile cache starts empty,
        so the decoder compiles (and would autotune) from scratch."""
        cache = path("cold_cache")
        shutil.rmtree(cache, ignore_errors=True)
        os.makedirs(cache)
        env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache)
        self.run(
            f"decode {tag} (fresh process, empty compile cache)",
            [sys.executable, "-m", "nvfpcc_tpu.cli", "decode", path(f"pack_{tag}.pk"),
             "--recon", path(f"rc_dec_{tag}.ply")],
            env=env,
        )
        import numpy as np

        a, b = read_points(f"rc_enc_{tag}.ply"), read_points(f"rc_dec_{tag}.ply")
        check(a.shape == b.shape and np.array_equal(a, b), f"rc_enc == rc_dec ({tag}, {len(b)} points)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true", help="run only the four-GPU block-DP check")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.phase:
        return run_phase(args.phase)

    import nvfpcc_tpu  # noqa: F401  (outside a checkout this fails before any phase)

    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; print(json.dumps(chip_smoke.device_info()))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    if probe.returncode:
        sys.stderr.write(probe.stderr)
        raise SystemExit("chip_smoke: JAX could not start")
    dev = json.loads(probe.stdout.strip().splitlines()[-1])
    require_gpu(dev, 4 if args.four else 1)
    print(gpu_name_and_power(), flush=True)  # name, power limit
    print(f"jax device: {dev}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    runner = Runner()
    try:
        if args.four:
            runner.phase("four")
        else:
            runner.phase("grids")
            runner.phase("fit")
            for tag in ("f32", "bf16", "ctx"):
                runner.fresh_decode(tag)
            runner.phase("eval")
    except SmokeFailure as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(f"all phases passed in {time.monotonic() - runner.t0:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
