"""Encode/decode orchestration + the ``pack.pk`` bitstream container.

Capability rebuild of the reference codec driver (``NVFPCC.py:395-554``
``encode``, ``:557-652`` ``decode``): the transmitted artifact is a pickled
dict with three payloads — entropy-packed decoder weights, octree-coded
block origins (~2.5 bits/block vs the reference's raw int16 at 48 bits),
and range-coded latents — plus enough model metadata to rebuild the
(seeded-init) decoder with no side files.

Fidelity gate: encoder and decoder run the *identical* reconstruction program
(quantized weights + integer latents through :func:`reconstruct_all`), so
``rc_enc.ply == rc_dec.ply`` exactly (reference ``README.md:63``; shared path
``NVFPCC.py:496-554`` vs ``:620-650``). All quantization (weights to the 1/qp
grid, latents to integers) happens on host before either side runs, and the
reconstruction program compiles deterministically on the GPU
(:data:`RECON_COMPILER_OPTIONS`), so parity holds across processes on one
device type.

Departures from the reference:
- reconstruction is batched over blocks through one jitted forward (the
  reference loops blocks with B=1, ``NVFPCC.py:613-638``),
- thresholding + point extraction is a dense compare + ``argwhere`` (drops
  the MinkowskiEngine sparse/prune dependency, ``NVFPCC.py:421-430``),
- the decoder params pytree is decode-minimal (no aux heads); the latent
  entropy model's (sigma, mu) travel in the latent pack as exact f32.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nvfpcc_tpu.codec import weights as W
from nvfpcc_tpu.coder import range_coder as RC
from nvfpcc_tpu.config import CodecConfig, ModelConfig
from nvfpcc_tpu.models import decoder as M

# v4: per-kernel-histogram weight stream (net_weight_pack mode="range_pl",
# default — measured 2.7-3.0% under the global histogram at vox10).
# v3 = global-histogram range weights (mode="range") + context-model latent
# packs (latent_pack mode="ctx"). v2 = Huffman weights, channel/spatio
# latents, octree origins. v1 = raw int16 origins. All decodable.
PACK_FORMAT_VERSION = 4
_DECODABLE_VERSIONS = (1, 2, 3, 4)

# One jitted reconstruct per model spec (keyed by its static identity): a
# warm process re-traces nothing across encode/decode/serve requests
# (round-1 rebuilt the jit per call, costing a re-trace + lowering each time).
# LRU-bounded so a long-lived serve process fed many model shapes cannot
# accumulate jitted programs without limit.
_RECON_JIT_CACHE: OrderedDict = OrderedDict()
_RECON_JIT_CACHE_MAX = 32

# Cross-process parity on the GPU: XLA picks each convolution's algorithm by
# timing the candidates, so two cold processes can pick differently and
# disagree in the last bits of the f32 occupancy field (measured on an H100:
# three cold processes gave three different f32 fields, a few voxels apart at
# thh 0.5). Deterministic ops turn that autotuning off for the reconstruction
# program alone, so the encoder and every decoder compile the same
# algorithms; training keeps its autotuned convs. The CPU backend ignores it.
RECON_COMPILER_OPTIONS = {"xla_gpu_deterministic_ops": True}


def _jit_cache_get(key, build):
    fn = _RECON_JIT_CACHE.get(key)
    if fn is None:
        fn = build()
        _RECON_JIT_CACHE[key] = fn
        while len(_RECON_JIT_CACHE) > _RECON_JIT_CACHE_MAX:
            _RECON_JIT_CACHE.popitem(last=False)
    else:
        _RECON_JIT_CACHE.move_to_end(key)
    return fn


def _spec_key(spec: M.ModelSpec):
    return (
        spec.ch, spec.channels, spec.seed_tag, spec.entropy_mode,
        spec.ctx_hidden, getattr(spec, "ctx_tail", 0),
    )


def _bf16_twin_spec(spec: M.ModelSpec) -> M.ModelSpec:
    """Twin spec whose seeded-init buffers are pre-cast to bfloat16 so the
    bf16 decode forward sees uniformly-bf16 operands (the inits live in the
    frozen spec, not the params tree)."""
    import dataclasses

    import ml_dtypes

    specs16 = {
        name: dataclasses.replace(
            s,
            kernel_init=np.asarray(s.kernel_init, ml_dtypes.bfloat16),
            b_init=None if s.b_init is None else np.asarray(s.b_init, ml_dtypes.bfloat16),
        )
        for name, s in spec.specs.items()
    }
    return dataclasses.replace(spec, specs=specs16)


def _recon_fn(spec: M.ModelSpec, recon_dtype: str = "f32"):
    """Jitted reconstruct for the pack's ``codec.recon_dtype``.

    ``bf16`` runs the decode chain in bfloat16 (~0.8% of thresholded voxels
    flip vs f32, RESULTS.md round-2 analysis). Parity is structural either
    way: the dtype rides in the pack, so
    encoder and decoder run the identical program; the f32 occupancy compare
    happens after an exact bf16->f32 upcast."""
    if recon_dtype == "f32":
        return _jit_cache_get(
            _spec_key(spec),
            lambda: jax.jit(
                lambda p, l: M.reconstruct(spec, p, l, q=2),
                compiler_options=RECON_COMPILER_OPTIONS,
            ),
        )
    if recon_dtype != "bf16":
        raise ValueError(f"unsupported recon_dtype: {recon_dtype!r}")

    def build():
        spec16 = _bf16_twin_spec(spec)

        def cast(t):
            return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), t)

        return jax.jit(
            lambda p, l: M.reconstruct(
                spec16, cast(p), l.astype(jnp.bfloat16), q=2
            ).astype(jnp.float32),
            compiler_options=RECON_COMPILER_OPTIONS,
        )

    return _jit_cache_get(_spec_key(spec) + ("bf16",), build)


def encode_origins(origins: np.ndarray, depth: int, level: int) -> dict:
    """Origins payload as trimmed octree occupancy bits (~2.5 bits/block).

    The reference transmits raw 3x int16 per block (``NVFPCC.py:436-439``,
    48 bits/block) even though its own octree tool already computes the
    subtree occupancy string; here the string IS the payload. Lossless by
    construction (round-trip asserted)."""
    from nvfpcc_tpu.octree import partition as OT

    s = OT.subtree_occupancy_string(np.asarray(origins, np.int64), depth, level - 1)
    payload = {
        "mode": "octree",
        "bits": OT.pack_occupancy_bits(s),
        "n_bits": len(s),
    }
    rt = decode_origins(payload, depth, level)
    assert np.array_equal(rt, np.asarray(origins, np.int64)), "origins round-trip"
    return payload


def decode_origins(payload, depth: int, level: int) -> np.ndarray:
    """Inverse of :func:`encode_origins`; also accepts the v1 raw-int16 form."""
    from nvfpcc_tpu.octree import partition as OT

    if isinstance(payload, np.ndarray):  # format v1
        return np.asarray(payload, np.int64)
    s = OT.unpack_occupancy_bits(payload["bits"], payload["n_bits"])
    return OT.occupancy_to_origins(s, depth, level, with_leaf_children=False)


def _model_latent_tables(mode: str, params: dict, ch: int) -> np.ndarray:
    """Per-channel integer CDF tables for the gmm/factorized latent modes,
    built from the exact f32 params that travel in the pack (both sides call
    this same function — the determinism contract of docs/FORMAT.md)."""
    if mode == "gmm":
        return RC.build_cum_tables_gmm(
            np.asarray(params["sigma"]), np.asarray(params["mu"]),
            np.asarray(params["p_logit"]),
        )
    if mode == "factorized":
        return RC.build_cum_tables_factorized(params, ch)
    raise ValueError(f"unknown latent table mode: {mode}")


@dataclass
class EncodeResult:
    pack: dict
    points: np.ndarray  # reconstructed points (M, 3) int64
    stats: dict  # bpp split etc.


def reconstruct_all(
    spec: M.ModelSpec,
    params: dict,
    latents: np.ndarray,
    batch: int = 128,
    recon_dtype: str = "f32",
) -> np.ndarray:
    """Occupancy grids (N, B, B, B) f32 for all blocks, batched through one
    jitted decode forward (pad-to-fixed-batch so XLA compiles once)."""
    n = latents.shape[0]
    batch = min(batch, max(n, 1))
    fn = _recon_fn(spec, recon_dtype)
    outs = []
    for i in range(0, n, batch):
        chunk = latents[i : i + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)]
            )
        out = np.asarray(fn(params, jnp.asarray(chunk, jnp.float32)))
        outs.append(out[: batch - pad] if pad else out)
    occ = np.concatenate(outs) if outs else np.zeros((0, 32, 32, 32, 1), np.float32)
    return occ[..., 0]


def reconstruct_points(
    spec: M.ModelSpec,
    params: dict,
    latents: np.ndarray,
    origins: np.ndarray,
    thh: float,
    batch: int = 128,
    recon_dtype: str = "f32",
) -> np.ndarray:
    """Reconstruct + threshold + extract WITHOUT fetching the occupancy field.

    The dense field is (N, 32^3) f32 — 126 MB at flagship scale, paid over
    the device->host link by the fetch-then-argwhere path. Instead: keep
    recon chunks on device, count above-threshold voxels
    (scalar fetch), compact indices on device with a power-of-two size bucket
    (bounds recompiles), and fetch only the indices (~4 MB per million
    points). Index order is ascending-flat = C order = identical to the host
    argwhere path (asserted in tests), so encode/decode parity is unaffected.
    """
    n = latents.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.int64)
    batch = min(batch, n)
    fn = _recon_fn(spec, recon_dtype)
    chunks = []
    for i in range(0, n, batch):
        chunk = latents[i : i + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)]
            )
        out = fn(params, jnp.asarray(chunk, jnp.float32))
        chunks.append(out[: batch - pad] if pad else out)
    occ = jnp.concatenate(chunks)[..., 0]
    block = occ.shape[1]
    mask = (occ > thh).reshape(-1)
    count = int(mask.sum())
    if count == 0:
        return np.zeros((0, 3), np.int64)
    cap = 1 << max(int(count - 1).bit_length(), 10)  # pow2 bucket >= count
    flat = np.asarray(jnp.nonzero(mask, size=cap, fill_value=0)[0][:count], np.int64)
    b, r = np.divmod(flat, block * block * block)
    x, r = np.divmod(r, block * block)
    y, z = np.divmod(r, block)
    return np.stack([x, y, z], axis=1) + np.asarray(origins, np.int64)[b]


def extract_points(
    occ: np.ndarray, origins: np.ndarray, thh: float
) -> np.ndarray:
    """Threshold occupancy grids and emit global voxel coordinates
    (reference's ME-sparse + prune + ``coords + origin``, ``NVFPCC.py:511-539``).

    Deterministic order: blocks in origin order, voxels in C order within a
    block — identical on encode and decode."""
    idx = np.argwhere(occ > thh)  # (M, 4): block, x, y, z — C-order sorted
    if len(idx) == 0:
        return np.zeros((0, 3), np.int64)
    return idx[:, 1:].astype(np.int64) + np.asarray(origins, np.int64)[idx[:, 0]]


def encode(
    params: dict,
    emb: np.ndarray,
    origins: np.ndarray,
    model_cfg: ModelConfig,
    codec_cfg: CodecConfig,
    n_points_src: int,
    spec: Optional[M.ModelSpec] = None,
) -> EncodeResult:
    """Produce the pack + the encoder-side reconstruction
    (reference ``encode()``, ``NVFPCC.py:395-554``)."""
    if spec is None:
        spec = M.build_model_spec(
            model_cfg.ch, model_cfg.channels, model_cfg.seed_tag,
            model_cfg.entropy_mode,
            ctx_hidden=getattr(model_cfg, "ctx_hidden", M.CTX_HIDDEN),
            ctx_tail=getattr(model_cfg, "ctx_tail", 0),
        )

    # [WEIGHTS] quantize to the 1/qp grid, entropy-pack (NVFPCC.py:409-410)
    qparams = W.quantize_residuals(params, codec_cfg.qp)
    net_weight_pack = W.pack_weights(qparams, codec_cfg.qp)

    # [LATENTS] integer latents + per-channel Gaussian range coding
    # (NVFPCC.py:444-477); round-trip asserted inside encode_latents.
    key = ("latent_code",) + _spec_key(spec)
    code_fn = _jit_cache_get(
        key, lambda: jax.jit(lambda p, e: M.get_latent_code(spec, p, e))
    )
    code = code_fn(qparams, jnp.asarray(emb, jnp.float32))
    lat_int = np.rint(np.asarray(code["quantized_latent"], np.float64)).astype(np.int64)
    if spec.entropy_mode in M.CTX_MODES:
        # context-model path (format v3): per-symbol tables derive from the
        # decoded prefix via the integer-exact host predictor; residual
        # clamping (if any) is applied in encoder/decoder lockstep inside
        # encode_latents_ctx.
        from nvfpcc_tpu.coder import ctx_coder as CTX

        ctx_payload = CTX.build_ctx_payload(spec, qparams["entropy"], codec_cfg.qp)
        ctx_ints = CTX.ctx_ints_from_payload(spec, ctx_payload)
        channel_ar = spec.entropy_mode == "ctx_ar"
        enc = CTX.encode_latents_ctx(lat_int, ctx_ints, channel_ar)
        if enc["n_clamped"]:
            import warnings

            warnings.warn(
                f"{enc['n_clamped']} ctx latent residual(s) clamped to the alphabet"
            )
        rt = CTX.decode_latents_ctx(enc["stream"], enc["shape"], ctx_ints, channel_ar)
        assert np.array_equal(rt, enc["coded"]), "ctx range coder round-trip failed"
        lat_int = enc["coded"]
        latent_pack = {
            "mode": spec.entropy_mode,
            "stream": enc["stream"],
            "shape": enc["shape"],
            "ctx": ctx_payload,
        }
        latent_extra_bits = CTX.ctx_payload_bits(ctx_payload)
    else:
        # clamp to the codable alphabet (reference maps into [0,1024] the same
        # way, NVFPCC.py:447-449); both sides reconstruct from the clamped ints,
        # so parity is unaffected — but warn, because it means training drifted.
        lo, hi = -RC.OFFSET, RC.N_SYM - RC.OFFSET - 1
        n_out = int(((lat_int < lo) | (lat_int > hi)).sum())
        if n_out:
            import warnings

            warnings.warn(
                f"{n_out} latent(s) outside the codable range [{lo}, {hi}] were clamped"
            )
            lat_int = np.clip(lat_int, lo, hi)
        if spec.entropy_mode in ("gmm", "factorized"):
            ep = {
                k: np.asarray(v, np.float32) for k, v in qparams["entropy"].items()
            }
            cum = _model_latent_tables(spec.entropy_mode, ep, spec.ch)
            latent_pack = {
                "mode": spec.entropy_mode,
                "params": ep,
                **RC.encode_latents_tables(lat_int, cum),
            }
            latent_extra_bits = 32 * sum(v.size for v in ep.values())
        else:
            latent_pack = RC.encode_latents(
                lat_int, np.asarray(code["sigma"]), np.asarray(code["mu"])
            )
            latent_extra_bits = 2 * latent_pack["sigma"].size * 32

    # [ORIGINS] trimmed octree occupancy bits (see encode_origins)
    origins_payload = encode_origins(origins, codec_cfg.depth, codec_cfg.level)

    pack = {
        "format_version": PACK_FORMAT_VERSION,
        "model": {
            "ch": model_cfg.ch,
            "chanstr": model_cfg.chanstr,
            "seed_tag": model_cfg.seed_tag,
            "entropy_mode": model_cfg.entropy_mode,
            # decoder must rebuild the same predictor width (absent = 8)
            **(
                {"ctx_hidden": int(spec.ctx_hidden)}
                if spec.entropy_mode in M.CTX_MODES
                else {}
            ),
            # tail-unit split changes the transmitted ctx2 taps (absent = 0,
            # so packs predating ctx_tail decode unchanged)
            **(
                {"ctx_tail": int(spec.ctx_tail)}
                if spec.entropy_mode in M.CTX_MODES and spec.ctx_tail
                else {}
            ),
        },
        "codec": {
            # the decode threshold; the encoder reconstructs at the same value
            # so rc_enc == rc_dec holds by construction. (The reference README
            # uses asymmetric 0.65/0.64 defaults — a quirk we do not keep;
            # pass a different thh to decode() explicitly to reproduce it.)
            "thh": float(codec_cfg.thh_encode),
            "qp": int(codec_cfg.qp),
            "depth": int(codec_cfg.depth),
            "level": int(codec_cfg.level),
            "n_points_src": int(n_points_src),
            # absent = f32 (packs predating the bf16 option decode unchanged)
            **(
                {"recon_dtype": "bf16"}
                if getattr(codec_cfg, "recon_dtype", "f32") == "bf16"
                else {}
            ),
        },
        "net_weight_pack": net_weight_pack,
        "origins": origins_payload,
        "latent_pack": latent_pack,
    }

    # Encoder-side reconstruction with the exact decode inputs AND the exact
    # decode params pytree (its own unpacked weight pack): encode and decode
    # trace byte-identical XLA programs, so they share one compilation-cache
    # entry and parity cannot drift.
    latents = (lat_int).astype(np.float32)
    points = reconstruct_points(
        spec, W.unpack_weights(net_weight_pack), latents, origins,
        codec_cfg.thh_encode,
        recon_dtype=getattr(codec_cfg, "recon_dtype", "f32"),
    )

    coded_w, as_is_w = W.weight_pack_bits(net_weight_pack)
    if spec.entropy_mode in M.CTX_MODES:
        # ctx side-info (masked kernel residual stream + biases) is network
        # weight, like the training objective counts it (ctx_kernel_bits)
        net_bits_total = coded_w + as_is_w + latent_extra_bits
        latent_bits = 8 * len(latent_pack["stream"])
    else:
        net_bits_total = coded_w + as_is_w
        latent_bits = 8 * len(latent_pack["stream"]) + latent_extra_bits
    origin_bits = origins_payload["n_bits"]
    total_bits = net_bits_total + latent_bits + origin_bits
    stats = {
        "n_blocks": int(len(origins)),
        "n_points_src": int(n_points_src),
        "n_points_rec": int(len(points)),
        "b_net": net_bits_total / n_points_src,
        "b_latent": latent_bits / n_points_src,
        "b_origins": origin_bits / n_points_src,
        "bpp": total_bits / n_points_src,
        "latent_stream_bytes": len(latent_pack["stream"]),
        "weight_stream_bytes": len(net_weight_pack["bit_stream"]),
    }
    return EncodeResult(pack=pack, points=points, stats=stats)


def decode_inputs(pack: dict):
    """(spec, params, latents, origins): everything the reconstruction
    program takes, rebuilt from the pack alone."""
    if pack.get("format_version") not in _DECODABLE_VERSIONS:
        raise ValueError(f"unsupported pack format: {pack.get('format_version')}")
    mc = pack["model"]
    model_cfg = ModelConfig(
        ch=int(mc["ch"]), chanstr=mc["chanstr"], seed_tag=mc["seed_tag"],
        entropy_mode=mc.get("entropy_mode", "channel"),
        ctx_hidden=int(mc.get("ctx_hidden", M.CTX_HIDDEN)),
        ctx_tail=int(mc.get("ctx_tail", 0)),
    )
    spec = M.build_model_spec(
        model_cfg.ch, model_cfg.channels, model_cfg.seed_tag,
        model_cfg.entropy_mode, ctx_hidden=model_cfg.ctx_hidden,
        ctx_tail=model_cfg.ctx_tail,
    )

    params = W.unpack_weights(pack["net_weight_pack"])
    lp = pack["latent_pack"]
    if lp.get("mode") in M.CTX_MODES:
        from nvfpcc_tpu.coder import ctx_coder as CTX

        ctx_ints = CTX.ctx_ints_from_payload(spec, lp["ctx"])
        latents = CTX.decode_latents_ctx(
            lp["stream"], tuple(lp["shape"]), ctx_ints,
            channel_ar=lp["mode"] == "ctx_ar",
        ).astype(np.float32)
    elif lp.get("mode") in ("gmm", "factorized"):
        cum = _model_latent_tables(lp["mode"], lp["params"], int(lp["shape"][-1]))
        latents = RC.decode_latents_tables(lp["stream"], tuple(lp["shape"]), cum)
    else:
        latents = RC.decode_latents(lp)
    origins = decode_origins(
        pack["origins"], int(pack["codec"]["depth"]), int(pack["codec"]["level"])
    )
    return spec, params, latents, origins


def decode(pack: dict) -> Tuple[np.ndarray, dict]:
    """Pure bitstream -> points (reference ``decode()``, ``NVFPCC.py:557-652``).

    Touches neither the dataset nor the latent generator; rebuilds the seeded
    decoder from the pack's model metadata alone."""
    spec, params, latents, origins = decode_inputs(pack)
    recon_dtype = str(pack["codec"].get("recon_dtype", "f32"))
    points = reconstruct_points(
        spec, params, latents, origins, float(pack["codec"]["thh"]),
        recon_dtype=recon_dtype,
    )
    info = {
        "n_blocks": int(len(origins)),
        "n_points_rec": int(len(points)),
        "thh": float(pack["codec"]["thh"]),
        "recon_dtype": recon_dtype,
    }
    return points, info


def save_pack(path: str, pack: dict) -> int:
    """Pickle the pack (reference ``pack.pk``, ``NVFPCC.py:486-493``).
    Returns the file size in bytes."""
    with open(path, "wb") as f:
        pickle.dump(pack, f, protocol=4)
    return os.path.getsize(path)


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickler that admits only the types a pack can legitimately contain.

    The container is pickle for reference parity (``NVFPCC.py:486-493``
    unpickles ``pack.pk`` with no restriction — arbitrary code execution on
    untrusted input); here ``find_class`` whitelists the numpy array
    reconstructors and nothing else, so a hostile pack cannot name an
    executable global. Everything else in a pack is builtin scalars,
    bytes, dicts, lists and tuples, which need no globals at all.
    """

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
    }

    def find_class(self, module: str, name: str):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"pack.pk may not reference {module}.{name} — refusing to unpickle"
        )


def load_pack(path: str) -> dict:
    """Load a pack with the restricted unpickler (see docs/FORMAT.md §Trust)."""
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()
