"""Command-line driver: ``grids | train | encode | decode``.

Workflow parity with the reference CLI surface (``NVFPCC.py:654-755`` plus the
preprocessing CLIs ``get_octree`` / ``util_get_grids.py``), collapsed into one
entry point:

    python -m nvfpcc_tpu.cli grids  cloud.ply --depth 10 --level 5
    python -m nvfpcc_tpu.cli train  cloud.ply --epochs 501 --checkpoint_dir ckpts
    python -m nvfpcc_tpu.cli encode cloud.ply --load_checkpoint ckpts \
        --pack_fn pack.pk --recon rc_enc.ply
    python -m nvfpcc_tpu.cli decode pack.pk --recon rc_dec.ply

The reference needs three separate preprocessing steps (C++ octree, origins
txt→npy, KD-tree grids); here ``grids`` builds and caches all artifacts in one
``.npz`` next to the cloud, and ``train``/``encode`` build it on demand.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def artifact_path(cloud: str, depth: int, level: int) -> str:
    stem, _ = os.path.splitext(cloud)
    return f"{stem}_d{depth}_l{level}_grids.npz"


def load_or_build_artifacts(
    cloud: str, depth: int, level: int, log=print, platform: str | None = None
) -> dict:
    """origins/gt/dist for a cloud, cached as one npz (reference's three .npy
    files, ``util_get_grids.py:16-46``). ``platform``: ``None`` (default)
    builds the grids on the ambient device, ``"cpu"`` on the host."""
    from nvfpcc_tpu.grids.builder import build_artifacts
    from nvfpcc_tpu.io.ply import read_ply_points

    path = artifact_path(cloud, depth, level)
    if os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(cloud):
        data = np.load(path)
        return {k: data[k] for k in ("origins", "gt", "dist")}
    t0 = time.time()
    points = np.rint(read_ply_points(cloud)).astype(np.int64)
    if points.min() < 0 or points.max() >= (1 << depth):
        raise SystemExit(f"cloud exceeds the 2^{depth} cube: [{points.min()}, {points.max()}]")
    origins, gt, dist = build_artifacts(points, depth, level, platform=platform)
    np.savez_compressed(path, origins=origins, gt=gt, dist=dist)
    log(
        f"[grids] {len(points)} pts -> {len(origins)} blocks of "
        f"{1 << (depth - level)}^3 in {time.time() - t0:.1f}s -> {path}"
    )
    return {"origins": origins, "gt": gt, "dist": dist}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--depth", type=int, default=10, help="voxel depth (vox10 -> 10)")
    p.add_argument("--level", type=int, default=5, help="octree partition level")
    p.add_argument(
        "--platform",
        choices=("default", "cpu"),
        default="default",
        help="default: all compute (grids, model, metrics) on the ambient "
        "device; cpu: pin all compute to the host",
    )


def _apply_platform(args) -> None:
    if getattr(args, "platform", "default") == "cpu":
        import jax

        # drop the accelerator platform entirely, so a cpu-pinned run neither
        # initializes nor reserves memory on a GPU. After backends are
        # initialized this update is a silent no-op, so in-process callers
        # that already touched a device keep working — the default-device
        # pin below still routes compute to host for them.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])


def _platform(args) -> str | None:
    """The ``platform`` argument of the grids builder and the metrics:
    ``None`` = ambient device, ``"cpu"`` = host."""
    return "cpu" if getattr(args, "platform", "default") == "cpu" else None


def _add_model(p: argparse.ArgumentParser) -> None:
    # ch/chanstr default to None so encode can tell "user said nothing" (fill
    # from the checkpoint metadata) apart from an explicit override
    p.add_argument(
        "--ch", type=int, default=None,
        help="latent channels (default 3; encode reads the checkpoint)",
    )
    p.add_argument(
        "--chanstr", type=str, default=None,
        help="decoder channels (default 8,16,8,8; encode reads the checkpoint)",
    )
    p.add_argument(
        "--entropy_mode",
        choices=("auto", "channel", "spatio", "ctx", "ctx_ar", "gmm", "factorized"),
        default="auto",
        help="latent entropy model: per-channel (sigma,mu); per-position "
        "(spatio); autoregressive masked-conv context prediction (ctx); "
        "ctx plus same-position channel autoregression (ctx_ar); per-channel "
        "2-component Gaussian mixture (gmm); per-channel factorized "
        "logit-CDF MLP (factorized). 'auto' (default) picks the measured "
        "best (RESULTS.md): train chooses per the measured decision table; "
        "encode reads the mode from the checkpoint metadata, upgrading ctx "
        "checkpoints with the post-hoc ctx_ar predictor fit (ctx_post) when "
        "the measured symbol-count break-even predicts a net stream saving",
    )
    p.add_argument(
        "--ctx_detach_pred", action="store_true",
        help="ctx modes: stop the rate gradient at the context predictor's "
        "input (training-time only; latents are then shaped by distortion + "
        "their own rate, not by making later positions predictable)",
    )
    p.add_argument(
        "--ctx_hidden", type=int, default=8,
        help="ctx modes: masked-conv predictor hidden width (8 = reference "
        "PredNet; travels in the pack model metadata)",
    )
    p.add_argument(
        "--ctx_tail", type=int, default=None,
        help="ctx_ar only: how many of the ctx_hidden units are payload-cheap "
        "tail units (full ctx1 receptive field, center-only ctx2 taps — "
        "~1/7 the transmitted taps per unit; travels in the pack model "
        "metadata). Default: the checkpoint's trained value at encode, 0 at "
        "train (every unit full-width)",
    )


def resolve_auto_train(level: int, n_symbols: int) -> str:
    """`--entropy_mode auto` at train time. The round-4 same-driver A/B
    (RESULTS.md round 4: one fresh 501-epoch channel train per shape, same
    clouds/thresholds as the ctx arms)
    measured channel dominating the co-trained ctx recipe on ALL THREE vox10
    shapes (sphere: -4.3% rate AND +0.42 dB; torus: -14.7% AND +0.34 dB;
    helix: channel@0.70 beats ctx@0.65 on both axes) — the round-2
    single-shape ctx dominance did not replicate, so channel is the default.
    ctx is trained only where the encode recipe needs a ctx-family
    checkpoint: at level >= 6 (vox11-like scales, where latents dominate the
    pack and ctx -> ctx_post is the measured strictly-dominant recipe) AND
    when the same break-even economics the encode gate uses predict the
    ctx_post upgrade pays its predictor payload at this cloud's symbol count
    (:func:`ctx_post_break_even`). Channel-trained latents are measured
    conditionally unpredictable (RESULTS.md round 3), so this choice cannot
    be deferred to encode time."""
    if level >= 6 and ctx_post_break_even(n_symbols)[0] > 0:
        return "ctx"
    return "channel"


# Measured ctx_post economics (results/round5/ctx_capacity2.json: exhaustive
# post-hoc ctx_ar fits with REAL coded bits on the frozen vox11 l200
# ctx-checkpoint latents under the production bf16 recipe, 127,824 symbols,
# marginal 2.2856 b/sym): per (hidden, tail) candidate, the expected
# latent-stream cut in bits/symbol vs the moment-fit marginal and the
# transmitted-predictor payload in bits. h32t24 dominates every other row on
# BOTH axes (largest cut at the smallest payload — the tail units code the
# stream better AND cost ~1/7 the taps), so the gate effectively always
# picks it; the dominated rows stay as measured documentation. The round-3
# f32-recipe table (h8/h16/h32, marginal 3.869, cuts 0.21-0.34 b/sym —
# results/round3/ctx_capacity_sweep.json) is retired: the bf16 trajectory
# lands on far lower-entropy latents and the conditional cuts collapse ~2.5x
# with it (RESULTS.md round 5). Single-cloud provenance: vox11-sphere
# constants used as a break-even model, not re-measured per cloud (vox11
# torus validation in results/round5/ctx_capacity2_torus.json); explicit
# --entropy_mode/--ctx_hidden/--ctx_tail flags remain authoritative
# overrides.
CTX_POST_ECONOMICS = (
    # (hidden, tail, expected stream cut b/sym, predictor payload bits)
    (16, 0, 2.2856 - 2.2050, 13_408.0),
    (32, 0, 2.2856 - 2.1904, 22_584.0),
    (32, 16, 2.2856 - 2.1806, 12_896.0),
    (32, 24, 2.2856 - 2.1582, 11_808.0),
)


def ctx_post_break_even(n_symbols: int):
    """(predicted net stream saving in bits, best hidden width, best tail)
    for a post-hoc ctx_ar upgrade of an n_symbols-latent pack. The saving
    model is ``n_symbols * cut(h,t) - payload(h,t)`` over the measured
    economics table; a non-positive best saving means the predictor payload
    would cancel the stream gain (the measured vox10 outcome, RESULTS.md
    E4). With the round-5 table the break-even edge is h32t24's
    ~93k symbols."""
    return max(
        (n_symbols * cut - payload, h, t)
        for h, t, cut, payload in CTX_POST_ECONOMICS
    )


def resolve_auto_encode(trained_mode: str, trained_hidden: int, n_symbols: int):
    """`--entropy_mode auto` at encode time -> (entropy_mode, ctx_hidden,
    ctx_tail, ctx_post). A ctx-family checkpoint is upgraded with the
    post-hoc fitted channel-AR predictor when the measured break-even model
    predicts a net stream saving at this cloud's symbol count
    (:func:`ctx_post_break_even` — the quantity that actually decides the
    trade; the round-3 ``level >= 6`` gate was a proxy for it and
    misclassified small-but-deep or large-but-shallow clouds). Measured
    anchors (round-5 table): vox11 sphere (127,824 symbols) predicts +4.5k
    bits at h32t24 and measured +4.7k vs the marginal floor
    (results/round5/ctx_capacity2.json); vox10 sphere (23,136 symbols)
    predicts negative and measured canceled (E4). Channel-trained latents
    are measured conditionally unpredictable (RESULTS.md round 3), so only
    ctx-family checkpoints upgrade."""
    if trained_mode in ("ctx", "ctx_ar"):
        gain, hidden, tail = ctx_post_break_even(n_symbols)
        if gain > 0:
            return "ctx_ar", hidden, tail, True
    return trained_mode, trained_hidden, 0, False


_DEFAULT_CH = 3
_DEFAULT_CHANSTR = "8,16,8,8"


def _model_cfg(args):
    from nvfpcc_tpu.config import ModelConfig

    return ModelConfig(
        ch=args.ch if args.ch is not None else _DEFAULT_CH,
        chanstr=args.chanstr if args.chanstr is not None else _DEFAULT_CHANSTR,
        entropy_mode=args.entropy_mode,
        ctx_detach_pred=getattr(args, "ctx_detach_pred", False),
        ctx_hidden=getattr(args, "ctx_hidden", 8),
        ctx_tail=getattr(args, "ctx_tail", None) or 0,
        ctx_train_init=getattr(args, "ctx_train_init", "zero"),
    )


def cmd_grids(args) -> int:
    _apply_platform(args)
    load_or_build_artifacts(
        args.cloud, args.depth, args.level, platform=_platform(args)
    )
    return 0


def cmd_train(args) -> int:
    from nvfpcc_tpu.config import TrainConfig
    from nvfpcc_tpu.train.loop import train

    _apply_platform(args)
    art = load_or_build_artifacts(
        args.cloud, args.depth, args.level, platform=_platform(args)
    )
    if args.entropy_mode == "auto":
        ch = args.ch if args.ch is not None else _DEFAULT_CH
        n_symbols = len(art["origins"]) * ch * 8
        args.entropy_mode = resolve_auto_train(args.level, n_symbols)
        print(
            f"[train] entropy_mode auto -> {args.entropy_mode} (round-4 "
            "decision table: channel dominates the co-trained ctx recipe at "
            "vox10 on all measured shapes; ctx only where the ctx_post "
            "upgrade pays at this symbol count — RESULTS.md)"
        )
    cfg = TrainConfig(
        lmbda=args.lmbda,
        w1=args.w1,
        w2=args.w2,
        wemb=args.wemb,
        lr=args.lr,
        batch_size=args.batchsize,
        epochs=args.epochs,
        phase_change=args.phase_change,
        shuffle=args.shuffle,
        eval_every=args.eval_every,
        compute_dtype=args.compute_dtype,
        emb_chunks=args.emb_chunks,
        seed=args.seed,
    )
    mesh = None
    if args.mesh:
        from nvfpcc_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
        print(f"[train] block-DP mesh over {mesh.devices.size} devices")
    train(
        art["gt"], art["dist"], _model_cfg(args), cfg,
        checkpoint_dir=args.checkpoint_dir, mesh=mesh,
        resume=args.resume, metrics_path=args.metrics,
        profile_dir=args.profile,
    )
    return 0


def _load_train_state(args, n_blocks: int):
    from nvfpcc_tpu.utils import checkpoint as C

    path = args.load_checkpoint
    if os.path.isdir(path):
        path = C.latest_checkpoint(path)
        if path is None:
            raise SystemExit(f"no checkpoints in {args.load_checkpoint}")
    params, emb, meta = C.load_checkpoint_meta(path)
    if emb is None:
        raise SystemExit(f"checkpoint {path} has no embeddings")
    if emb.shape[0] != n_blocks:
        raise SystemExit(
            f"checkpoint {path} has {emb.shape[0]} embedding rows but the cloud "
            f"partitions into {n_blocks} blocks — depth/level or artifact "
            "mismatch with the training run (latent rows would map to the "
            "wrong blocks)"
        )
    return params, emb, meta


def cmd_encode(args) -> int:
    from nvfpcc_tpu import codec
    from nvfpcc_tpu.config import CodecConfig
    from nvfpcc_tpu.io.ply import write_ply_points

    _apply_platform(args)
    art = load_or_build_artifacts(
        args.cloud, args.depth, args.level, platform=_platform(args)
    )
    n_blocks = len(art["origins"])
    n_points = int(art["gt"].sum())
    params, emb, meta = _load_train_state(args, n_blocks)
    # model-size flags live in the checkpoint metadata: fill unstated flags
    # from there (old checkpoints have no metadata -> built-in defaults) and
    # reject explicit overrides that contradict the trained shapes, which
    # would otherwise surface as a cryptic broadcast error deep in jit
    for flag, default in (("ch", _DEFAULT_CH), ("chanstr", _DEFAULT_CHANSTR)):
        trained_v = (meta or {}).get(flag)
        given_v = getattr(args, flag)
        if given_v is None:
            setattr(args, flag, trained_v if trained_v is not None else default)
        elif trained_v is not None and str(given_v) != str(trained_v):
            raise SystemExit(
                f"--{flag} {given_v} contradicts the checkpoint (trained with "
                f"--{flag} {trained_v}); drop the flag to use the trained value"
            )
    if args.ctx_tail is None:
        # a co-trained tail split is part of the trained predictor: encoding
        # with different masks would silently drop transmitted taps the
        # training relied on. ctx_post refits from scratch, so an explicit
        # flag (or the auto economics) may still choose a different split.
        args.ctx_tail = int((meta or {}).get("ctx_tail", 0))
    if args.entropy_mode == "auto":
        # the checkpoint knows what entropy model it was trained with;
        # old checkpoints without metadata are channel-era
        meta = meta or {}
        trained = str(meta.get("entropy_mode", "channel"))
        trained_hidden = int(meta.get("ctx_hidden", args.ctx_hidden))
        n_symbols = n_blocks * int(args.ch) * 8  # latent symbols this pack codes
        mode, hidden, tail, post = resolve_auto_encode(
            trained, trained_hidden, n_symbols
        )
        args.entropy_mode, args.ctx_hidden = mode, hidden
        if post and not args.ctx_post:
            args.ctx_post = True
            args.ctx_tail = tail  # the refit replaces the trained split
            gain, _, _ = ctx_post_break_even(n_symbols)
            print(
                f"[encode] entropy_mode auto -> ctx_ar + ctx_post (hidden "
                f"{hidden} tail {tail}): predicted net stream saving "
                f"{gain:.0f} bits at {n_symbols} symbols (measured break-even "
                "model, RESULTS.md); pass an explicit --entropy_mode to opt out"
            )
        else:
            print(
                f"[encode] entropy_mode auto -> {mode} (from checkpoint; "
                f"ctx_post break-even not met at {n_symbols} symbols)"
                if trained in ("ctx", "ctx_ar")
                else f"[encode] entropy_mode auto -> {mode} (from checkpoint)"
            )
    mcfg = _model_cfg(args)
    if args.ctx_post:
        # post-hoc predictor fit: entropy-upgrade ANY trained checkpoint to a
        # ctx/ctx_ar pack without touching its latents (same reconstruction,
        # smaller latent stream). See train/ctx_fit.py.
        if mcfg.entropy_mode not in ("ctx", "ctx_ar"):
            raise SystemExit(
                "--ctx_post needs --entropy_mode ctx or ctx_ar (it fits the "
                "masked-conv predictor the pack will carry)"
            )
        from nvfpcc_tpu.models import decoder as Mdl
        from nvfpcc_tpu.train.ctx_fit import upgrade_params_to_ctx

        spec = Mdl.build_model_spec(
            mcfg.ch, mcfg.channels, mcfg.seed_tag, mcfg.entropy_mode,
            ctx_hidden=mcfg.ctx_hidden,
            ctx_tail=getattr(mcfg, "ctx_tail", 0),
        )
        params = upgrade_params_to_ctx(
            spec, params, np.asarray(emb), steps=args.ctx_fit_steps,
            lr=args.ctx_fit_lr, early_stop=args.ctx_fit_early_stop,
            backend=args.ctx_fit_backend or None,
        )
    ccfg = CodecConfig(
        thh_encode=args.thh, thh_decode=args.thh, qp=args.qp,
        depth=args.depth, level=args.level, recon_dtype=args.recon_dtype,
    )
    result = codec.encode(
        params, emb, art["origins"], mcfg, ccfg, n_points
    )
    size = codec.save_pack(args.pack_fn, result.pack)
    s = result.stats
    print(
        f"[encode] {s['n_blocks']} blocks, {s['n_points_src']} pts -> "
        f"{size} B pack | bpp {s['bpp']:.4f} "
        f"(latent {s['b_latent']:.4f} net {s['b_net']:.4f} origins {s['b_origins']:.4f}) "
        f"| recon {s['n_points_rec']} pts"
    )
    if args.recon:
        write_ply_points(args.recon, result.points, ascii=False)
        print(f"[encode] wrote {args.recon}")
    return 0


def cmd_eval(args) -> int:
    """D1 PSNR between two point clouds (the pc_error-style check the
    reference leaves to external MPEG tooling)."""
    from nvfpcc_tpu.io.ply import read_ply_points
    from nvfpcc_tpu.metrics import d1_psnr

    _apply_platform(args)
    ref = np.rint(read_ply_points(args.ref)).astype(np.int64)
    rec = np.rint(read_ply_points(args.rec)).astype(np.int64)
    m = d1_psnr(
        ref, rec, depth=args.depth,
        platform=_platform(args),
    )
    print(
        f"[eval] D1 PSNR {m['psnr']:.4f} dB | mse(ref->rec) {m['mse_ab']:.6f} "
        f"mse(rec->ref) {m['mse_ba']:.6f} | {len(ref)} vs {len(rec)} pts"
    )
    if args.d2:
        from nvfpcc_tpu.metrics import d2_psnr

        m2 = d2_psnr(
            ref, rec, depth=args.depth,
            platform=_platform(args),
        )
        print(
            f"[eval] D2 PSNR {m2['psnr']:.4f} dB | p2plane mse(ref->rec) "
            f"{m2['mse_ab']:.6f} mse(rec->ref) {m2['mse_ba']:.6f}"
        )
    return 0


def cmd_weights(args) -> int:
    """Standalone weight quantize + entropy-pack report (reference
    ``manipulate_weights.py`` CLI + ``util_code_quantized_weights.py`` CLI:
    quantize a checkpoint to the 1/qp grid, Huffman-pack, verify lossless,
    report bits)."""
    from nvfpcc_tpu import codec
    from nvfpcc_tpu.utils import checkpoint as C

    params, emb = C.load_checkpoint(args.ckpt)
    qparams = codec.quantize_residuals(params, args.qp)
    pack = codec.pack_weights(qparams, args.qp)
    coded, as_is = codec.weight_pack_bits(pack)
    n_coded = pack["element_length"]
    print(
        f"[weights] {n_coded} residuals @ 1/{args.qp} -> {coded} bits coded "
        f"({coded / n_coded:.3f} b/residual) + {as_is} bits as-is fp32 "
        f"| lossless round-trip OK"
    )
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(
            args.out,
            **C.tree_to_flat(qparams),
            **({"__emb__": np.asarray(emb)} if emb is not None else {}),
        )
        print(f"[weights] wrote quantized checkpoint {args.out}")
    return 0


def cmd_decode(args) -> int:
    from nvfpcc_tpu import codec
    from nvfpcc_tpu.io.ply import write_ply_points

    _apply_platform(args)
    pack = codec.load_pack(args.pack)
    if args.thh is not None:
        pack["codec"]["thh"] = args.thh
    t0 = time.time()
    points, info = codec.decode(pack)
    print(
        f"[decode] {info['n_blocks']} blocks -> {info['n_points_rec']} pts "
        f"@ thh {info['thh']} in {time.time() - t0:.1f}s"
    )
    if args.recon:
        write_ply_points(args.recon, points, ascii=False)
        print(f"[decode] wrote {args.recon}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nvfpcc_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grids", help="build origins + occupancy/distance grids")
    g.add_argument("cloud")
    _add_common(g)
    g.set_defaults(fn=cmd_grids)

    t = sub.add_parser("train", help="overfit the codec to one cloud")
    t.add_argument("cloud")
    _add_common(t)
    _add_model(t)
    t.add_argument("--lambda", dest="lmbda", type=float, default=200.0)
    t.add_argument("--w1", type=float, default=10.0)
    t.add_argument("--w2", type=float, default=57.0)
    t.add_argument("--wemb", type=float, default=5.0)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--batchsize", type=int, default=16)
    t.add_argument("--epochs", type=int, default=501)
    t.add_argument("--phase_change", type=int, default=100)
    t.add_argument("--shuffle", choices=("stride", "random", "none"), default="stride")
    t.add_argument("--eval_every", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--checkpoint_dir", type=str, default="ckpts")
    t.add_argument("--mesh", action="store_true", help="block-DP over all devices")
    t.add_argument(
        "--resume", action="store_true",
        help="resume from the latest full train-state snapshot in checkpoint_dir",
    )
    t.add_argument(
        "--metrics", type=str, default=None,
        help="append one JSON line of metrics per epoch to this file",
    )
    t.add_argument(
        "--profile", type=str, default=None,
        help="write a jax profiler trace of post-compile epochs to this dir",
    )
    t.add_argument(
        "--ctx_train_init", choices=("zero", "feature"), default="zero",
        help="ctx modes: predictor init for co-training. zero = reference "
        "behavior, the measured RD default; feature = working-predictor "
        "init, measured worse for co-training (RESULTS.md E1/E3) but kept "
        "selectable",
    )
    t.add_argument(
        "--compute_dtype", choices=("f32", "bf16"), default="bf16",
        help="decoder-conv arithmetic precision during training (bf16 "
        "default = mixed precision, RD-neutral-or-better on all measured "
        "shapes; master params / rate / loss stay f32; --compute_dtype f32 "
        "restores the reference-exact recipe)",
    )
    t.add_argument(
        "--emb_chunks", type=int, default=0,
        help="full-set embedding-update block chunking; 0 = auto (single "
        "program up to 4096 blocks, then the smallest count keeping each "
        "chunk at or under 4096 blocks; the chunking is exact)",
    )
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("encode", help="pack weights+latents+origins -> pack.pk")
    e.add_argument("cloud")
    _add_common(e)
    _add_model(e)
    e.add_argument("--load_checkpoint", required=True, help="ckpt file or dir")
    e.add_argument("--pack_fn", type=str, default="pack.pk")
    e.add_argument("--recon", type=str, default=None, help="write rc_enc.ply here")
    e.add_argument("--thh", type=float, default=0.65)
    e.add_argument("--qp", type=int, default=16)
    e.add_argument(
        "--recon_dtype", choices=("f32", "bf16"), default="f32",
        help="reconstruction dtype; bf16 = bfloat16 decode chain with a "
        "small measured quality cost (rides in the pack — both sides run it)",
    )
    e.add_argument(
        "--ctx_post", action="store_true",
        help="fit the ctx/ctx_ar predictor post hoc on the checkpoint's "
        "frozen latents before packing (entropy upgrade: same reconstruction "
        "and D1 as the source checkpoint, smaller latent stream)",
    )
    e.add_argument("--ctx_fit_steps", type=int, default=3000)
    e.add_argument("--ctx_fit_lr", type=float, default=3e-2)
    e.add_argument(
        "--ctx_fit_early_stop", type=float, default=2e-3,
        help="end a ctx_post fit phase when a 250-step chunk improves the "
        "stream-bit estimate by less than this fraction (0 disables)",
    )
    e.add_argument(
        "--ctx_fit_backend", type=str, default="",
        help="device platform for the ctx_post fit; empty = the session's "
        "default device (any result is a valid pack; purely a wall-clock "
        "choice)",
    )
    e.set_defaults(fn=cmd_encode)

    ev = sub.add_parser("eval", help="D1 (and optional D2) PSNR between two .ply clouds")
    ev.add_argument("ref")
    ev.add_argument("rec")
    ev.add_argument(
        "--d2", action="store_true",
        help="also report point-to-plane (D2) PSNR — windowed-PCA normals "
        "per occupied voxel; adds ~a minute per million points",
    )
    _add_common(ev)
    ev.set_defaults(fn=cmd_eval)

    w = sub.add_parser(
        "weights", help="quantize + entropy-pack a checkpoint's weights (report bits)"
    )
    w.add_argument("ckpt")
    w.add_argument("--out", type=str, default=None, help="write quantized ckpt here")
    w.add_argument("--qp", type=int, default=16)
    w.set_defaults(fn=cmd_weights)

    d = sub.add_parser("decode", help="pack.pk -> reconstructed cloud")
    d.add_argument("pack")
    d.add_argument("--recon", type=str, default="rc_dec.ply")
    d.add_argument("--thh", type=float, default=None, help="override pack threshold")
    d.add_argument("--platform", choices=("default", "cpu"), default="default")
    d.set_defaults(fn=cmd_decode)
    return ap


def main(argv=None) -> int:
    from nvfpcc_tpu.utils.cache import enable_compilation_cache, enable_hang_diagnostics

    enable_compilation_cache()
    enable_hang_diagnostics()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
