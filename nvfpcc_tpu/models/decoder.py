"""The NVF codec model: latent generator + entropy bottleneck + CompDecoder.

Functional rebuild of the reference model stack (``NVFPCC.py:32-74`` ``Net``;
``utils/network.py:4490-4552`` ``QuantGaussianLikelihood``; ``:4592-4612``
``SingleLayerLatentGen``; ``:4648-4799`` active ``CompDecoder``), redesigned
for a compiled, batched forward:

- channels-last NDHWC activations, all blocks batched through one jitted
  forward (the reference loops blocks with B=16; the full-set passes batch
  the whole leaf set),
- static ``q`` phase (1 = additive-noise proxy, 2 = STE hard rounding) so XLA
  compiles exactly two variants of the step,
- explicit PRNG keys for all quantization noise (the reference uses global
  torch RNG).

Decoder shape chain on a 2^3 latent (reference ``utils/network.py:4758-4770``):
``up0``(k5 s2 p2 op1) 2->4 + IGDN, ``conv0``(deconv k5 s2 p2 op1) 4->8 + ReLU
[aux head conv0_cls], ``up1``(deconv k5 s2) 8->19 + ReLU, ``conv1``(k4 valid)
19->16 + ReLU [aux head conv1_cls], ``up2``(deconv k5 s2) 16->35 + ReLU,
``conv2``(k4 valid) 35->32 + ReLU, ``conv2_cls``(k3 p1) + sigmoid -> occupancy.

Exactly 7 kernels are transmitted (quantized residuals):
up0, conv0, up1, conv1, up2, conv2, conv2_cls — reference
``CompDecoder.get_q_params`` (``utils/network.py:4781-4792``). The aux heads
conv0_cls/conv1_cls and the latent generator are training-only and never
shipped (reference decode loads ``strict=False`` without them,
``NVFPCC.py:577-583``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nvfpcc_tpu.ops import conv as qc
from nvfpcc_tpu.ops import gdn, rate
from nvfpcc_tpu.ops.ste import bypass_round, bypass_round16
from nvfpcc_tpu.utils import seeds

# stable per-layer seed indices (decoder-regenerable; order is part of the format)
_LAYER_SEED_IDX = {
    "latent_gen": 0,
    "up0": 1,
    "conv0": 2,
    "up1": 3,
    "conv1": 4,
    "up2": 5,
    "conv2": 6,
    "conv2_cls": 7,
    "conv1_cls": 8,
    "conv0_cls": 9,
    # latent context model (entropy_mode="ctx"); appending here keeps every
    # older layer's seed stream unchanged, so pre-ctx packs decode bit-exactly
    "ctx1": 10,
    "ctx2": 11,
}

TRANSMITTED_KERNELS = ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")

# context-model layers whose (masked) kernel residuals are transmitted
CTX_KERNELS = ("ctx1", "ctx2")
CTX_MODES = ("ctx", "ctx_ar")  # spatial-only / + channel-autoregressive
# default PredNet hidden width (reference utils/network.py:4385-4388); wider
# predictors are a format-visible model choice (pack model.ctx_hidden)
CTX_HIDDEN = 8
CTX_SIGMA_FLOOR = 1e-6  # reference PredNet sigma floor (utils/network.py:4405)
# leaky-relu slope between the two masked convs. The reference uses torch's
# 0.01 default; we use 1/16 so the host-side integer-exact prediction path
# (coder/ctx_coder.py) stays exact in fixed-point — a function-class change
# only, never a parity concern (training and coding both use 1/16).
CTX_LRELU_SLOPE = 1.0 / 16.0


@dataclass(frozen=True)
class ModelSpec:
    """Static model description: channel plan + per-layer specs with seeded inits."""

    ch: int  # latent channels
    channels: Tuple[int, int, int, int]
    specs: dict  # name -> QSpec
    seed_tag: str
    entropy_mode: str = "channel"  # "channel" | "spatio" | ctx family | ...
    ctx_hidden: int = CTX_HIDDEN  # masked-conv predictor hidden width
    ctx_tail: int = 0
    """ctx_ar only: the last ``ctx_tail`` of the ``ctx_hidden`` units are
    payload-cheap "tail" features — full causal ctx1 taps (they extract
    neighborhood features like any unit) but ctx2 reads them ONLY through the
    channel-gated center tap. This decouples predictor width from the
    dominant payload term (ctx2's 13 spatial taps x hidden x 2ch): a tail
    unit costs ~1/7 the coded taps of a full unit. Format-visible (masks
    define what is transmitted): travels in the pack model metadata
    (``codec.codec.encode`` writes ``model.ctx_tail`` when nonzero; absent
    = 0 keeps older packs decodable), in checkpoint metadata, and on the
    CLI (``--ctx_tail``). See docs/FORMAT.md §Context model."""
    ctx_detach_pred: bool = False
    """Training-only (never part of the pack format): stop the rate gradient
    at the context predictor's INPUT. With the reference semantics (False),
    the rate term pushes earlier latent positions to make later ones
    predictable — measured at vox11 this warps latents enough to cost ~1 dB
    of reconstruction quality; detaching keeps the predictor adaptive while
    leaving the latents shaped only by distortion + their own rate."""

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        return (2, 2, 2, self.ch)


def build_model_spec(
    ch: int = 3,
    channels: Tuple[int, int, int, int] = (8, 16, 8, 8),
    seed_tag: str = seeds.DEFAULT_TAG,
    entropy_mode: str = "channel",
    ctx_detach_pred: bool = False,
    ctx_hidden: int = CTX_HIDDEN,
    ctx_tail: int = 0,
) -> ModelSpec:
    """Construct layer specs mirroring the reference architecture
    (``utils/network.py:4652-4751``)."""
    key = seeds.base_key(seed_tag)
    c0, c1, c2, c3 = channels
    if ctx_tail and entropy_mode != "ctx_ar":
        raise ValueError(
            "ctx_tail needs entropy_mode=ctx_ar (plain ctx keeps the "
            "reference's strict masks, whose ctx2 has no center tap — a "
            "center-only tail unit would be unreadable)"
        )
    if not 0 <= ctx_tail < max(ctx_hidden, 1):
        raise ValueError(f"ctx_tail must be in [0, ctx_hidden), got {ctx_tail}")

    def k(name):
        return seeds.layer_key(key, _LAYER_SEED_IDX[name])

    specs = {
        "latent_gen": qc.make_qspec(k("latent_gen"), "conv", ch, ch, 1, 1, 0),
        "up0": qc.make_qspec(k("up0"), "conv_transpose", ch, c0, 5, 2, 2, output_padding=1),
        "conv0": qc.make_qspec(k("conv0"), "conv_transpose", c0, c1, 5, 2, 2, output_padding=1),
        "up1": qc.make_qspec(k("up1"), "conv_transpose", c1, c2, 5, 2, 0),
        "conv1": qc.make_qspec(k("conv1"), "conv", c2, c2, 4, 1, 0),
        "up2": qc.make_qspec(k("up2"), "conv_transpose", c2, c3, 5, 2, 0),
        "conv2": qc.make_qspec(k("conv2"), "conv", c3, c3, 4, 1, 0),
        "conv2_cls": qc.make_qspec(k("conv2_cls"), "conv", c3, 1, 3, 1, 1),
        "conv1_cls": qc.make_qspec(k("conv1_cls"), "conv", c2, 1, 3, 1, 1),
        "conv0_cls": qc.make_qspec(k("conv0_cls"), "conv", c1, 1, 3, 1, 1),
    }
    if entropy_mode == "ctx":
        # autoregressive per-position mu/sigma predictor over the 2^3 latent
        # (reference PredNet: two causal masked convs, utils/network.py:4381-4412)
        specs["ctx1"] = qc.make_masked_qspec(k("ctx1"), ch, ctx_hidden, 3)
        specs["ctx2"] = qc.make_masked_qspec(k("ctx2"), ctx_hidden, 2 * ch, 3)
    elif entropy_mode == "ctx_ar":
        # ctx + channel autoregression: (mu_c, sigma_c) additionally see the
        # SAME position's channels < c (the reference mask zeroes the whole
        # center tap; latent channels are strongly correlated, so this is
        # pure extra context at ~40 extra coded taps). Decode order becomes
        # (position, channel) raster — 8*ch host steps.
        m1 = qc.channel_ar_mask(
            3, ch, ctx_hidden,
            in_group=lambda i: i, out_group=lambda g: g % ch,
            center_strict=True,
        )
        m2 = qc.channel_ar_mask(
            3, ctx_hidden, 2 * ch,
            in_group=lambda g: g % ch, out_group=lambda o: o % ch,
            center_strict=False,
        )
        if ctx_tail:
            # tail units: keep only the (channel-gated) center ctx2 tap
            center = m2[1, 1, 1, ctx_hidden - ctx_tail :, :].copy()
            m2[:, :, :, ctx_hidden - ctx_tail :, :] = 0.0
            m2[1, 1, 1, ctx_hidden - ctx_tail :, :] = center
        specs["ctx1"] = qc.make_masked_qspec(k("ctx1"), ch, ctx_hidden, 3, mask=m1)
        specs["ctx2"] = qc.make_masked_qspec(k("ctx2"), ctx_hidden, 2 * ch, 3, mask=m2)
    elif entropy_mode not in ("channel", "spatio", "gmm", "factorized"):
        raise ValueError(f"unknown entropy_mode: {entropy_mode}")
    return ModelSpec(
        ch=ch, channels=tuple(channels), specs=specs, seed_tag=seed_tag,
        entropy_mode=entropy_mode, ctx_hidden=ctx_hidden, ctx_tail=ctx_tail,
        ctx_detach_pred=ctx_detach_pred,
    )


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def ctx_feature_init(spec: ModelSpec) -> dict:
    """Structured init for the masked-conv predictor (ctx modes).

    From the standard init (zero residuals + small seeded Kaiming), gradient
    descent on the predictor reliably stalls near the MARGINAL rate: with
    both masked layers near zero, each layer's gradient is proportional to
    the other's weights, so the model learns sigma but never mu (measured in
    round 3: 4.39 b/sym on a toy whose linear-conditional bound is 3.06; the
    round-2 co-trained vox11 ctx predictor coded WORSE than its latents'
    marginal for the same reason). This seeds layer 1 with +-pass-through
    pairs — unit pairs carrying x[p+d, c] for the axis-neighbor offsets and,
    in ctx_ar, the same-position earlier channels through the gated center —
    placed in hidden groups the layer-2 center gate can read (group of unit
    i is i % ch, matching ``ops.conv.channel_ar_mask``). A +- pair is an
    exact linear basis under the leaky-1/16 nonlinearity, so the layer-2
    readout becomes a quasi-linear fit. Layer 2 starts at zero; both layers'
    seeded inits are cancelled so the features are clean (measured better
    than injecting on top of the random inits, vox10 probe round 3)."""
    ch = spec.ch
    out = {n: qc.conv_init(spec.specs[n]) for n in CTX_KERNELS}
    s1 = spec.specs["ctx1"]
    hidden = s1.out_ch
    # cancel the seeded init so the features are exact (measured better than
    # injecting on top of the random init: cleaner features out-fit the
    # payload cost of the extra nonzero residuals — vox10 probe, round 3)
    k1 = -np.asarray(s1.kernel_init, np.float64).copy()
    mask1 = np.broadcast_to(np.asarray(s1.mask), s1.kernel_shape)
    groups = {g: [i for i in range(hidden) if i % ch == g] for g in range(ch)}
    spatial = [
        (dz, dy, dx, c)
        for (dz, dy, dx) in ((0, 0, -1), (0, -1, 0), (-1, 0, 0))
        for c in range(ch)
    ]
    g0 = groups[0]
    pairs = [(g0[2 * j], g0[2 * j + 1]) for j in range(len(g0) // 2)]
    for (dz, dy, dx, c), (up, um) in zip(spatial, pairs):
        k1[dz + 1, dy + 1, dx + 1, c, up] += 1.0
        k1[dz + 1, dy + 1, dx + 1, c, um] -= 1.0
    if spec.entropy_mode == "ctx_ar":
        used: set = set()
        for cp in range(ch - 1):
            cands = [
                i for g in range(cp + 1, ch) for i in groups[g] if i not in used
            ]
            if len(cands) >= 2:
                up, um = cands[0], cands[1]
                used.update((up, um))
                k1[1, 1, 1, cp, up] += 1.0
                k1[1, 1, 1, cp, um] -= 1.0
    k1 *= mask1  # no energy on masked taps (they are never coded)
    out["ctx1"]["kernel"] = jnp.asarray(k1, jnp.float32)
    s2 = spec.specs["ctx2"]
    k2 = -np.asarray(s2.kernel_init, np.float64) * np.broadcast_to(
        np.asarray(s2.mask), s2.kernel_shape
    )
    out["ctx2"]["kernel"] = jnp.asarray(k2, jnp.float32)
    return out


def init_params(spec: ModelSpec) -> dict:
    """Full trainable pytree. Residual kernels start at zero; entropy-model
    sigma at 1, mu at 0 (reference ``utils/network.py:4504-4512``).

    The ctx predictor ALSO starts at zero residuals, like the reference —
    deliberately, despite the optimization deadlock :func:`ctx_feature_init`
    fixes: round-3 A/B runs showed co-training with a WORKING predictor is
    an RD net loss (vox10 ctx b_latent 0.0917 → 0.1070; vox11 ctx_ar
    dominated by channel), because the large co-trained rate cuts come from
    the rate gradient warping latents toward predictability — a weak
    predictor maximizes that pressure. The feature init is the default for
    POST-HOC fitting (``train/ctx_fit.py``), where it measurably wins."""
    p = {name: qc.conv_init(s) for name, s in spec.specs.items()}
    if spec.entropy_mode in CTX_MODES:
        entropy = {"ctx1": p["ctx1"], "ctx2": p["ctx2"]}
    elif spec.entropy_mode == "gmm":
        entropy = rate.gmm2_init(spec.ch)
    elif spec.entropy_mode == "factorized":
        entropy = rate.factorized_init(spec.ch)
    else:
        e_shape = (spec.ch,) if spec.entropy_mode == "channel" else spec.latent_shape
        entropy = {
            "sigma": jnp.ones(e_shape, jnp.float32),
            "mu": jnp.zeros(e_shape, jnp.float32),
        }
    return {
        "latent_gen": {"conv": p["latent_gen"], "gdn": gdn.gdn_init(spec.ch)},
        "entropy": entropy,
        "decoder": {
            "up0": p["up0"],
            "conv0": p["conv0"],
            "up1": p["up1"],
            "conv1": p["conv1"],
            "up2": p["up2"],
            "conv2": p["conv2"],
            "conv2_cls": p["conv2_cls"],
            "conv1_cls": p["conv1_cls"],
            "conv0_cls": p["conv0_cls"],
            "igdn": gdn.gdn_init(spec.channels[0]),
            "wrate": rate.scalar_gaussian_rate_params(),
        },
    }


def init_embeddings(n_blocks: int, ch: int) -> jnp.ndarray:
    """Per-block latent embeddings, channels-last (N, 2, 2, 2, ch), init ones
    (reference ``NVFPCC.py:120-123``)."""
    return jnp.ones((n_blocks, 2, 2, 2, ch), jnp.float32)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def latent_gen_apply(spec: ModelSpec, params: dict, emb: jnp.ndarray) -> jnp.ndarray:
    """1x1x1 seeded conv + GDN (reference ``SingleLayerLatentGen``,
    ``utils/network.py:4592-4612``)."""
    h = qc.iconv3d(spec.specs["latent_gen"], params["latent_gen"]["conv"], emb)
    return gdn.gdn_apply(params["latent_gen"]["gdn"], h)


def ctx_pred_apply(
    spec: ModelSpec,
    params: dict,
    x_rounded: jnp.ndarray,
    q: int,
    key: Optional[jax.Array] = None,
):
    """Autoregressive per-position (mu, sigma) prediction from causally-prior
    latent positions (reference ``PredNet.forward``, ``utils/network.py:4398-4407``):
    two quantized causal masked convs with a leaky-relu between, sigma floored.
    Input is always the ROUNDED latent (teacher forcing in train; at decode the
    host coder evaluates the identical function incrementally)."""
    if q == 1:
        if key is None:
            raise ValueError("q=1 ctx prediction needs a PRNG key")
        k1, k2 = jax.random.split(key)
    else:
        k1 = k2 = None
    ep = params["entropy"]
    h = qc.qconv3d(spec.specs["ctx1"], ep["ctx1"], x_rounded, q, k1)
    h = jax.nn.leaky_relu(h, CTX_LRELU_SLOPE)
    out = qc.qconv3d(spec.specs["ctx2"], ep["ctx2"], h, q, k2)
    mu = out[..., : spec.ch]
    sigma = jnp.abs(out[..., spec.ch :]) + CTX_SIGMA_FLOOR
    return mu, sigma


def entropy_apply(
    spec: ModelSpec,
    params: dict,
    x: jnp.ndarray,
    mode: str,
    key: Optional[jax.Array] = None,
    q: int = 2,
):
    """Latent bottleneck: STE round + Gaussian rate, additive noise in train
    (reference ``QuantGaussianLikelihood.forward``, ``utils/network.py:4514-4539``;
    for ``entropy_mode="ctx"`` the reference semantics are
    ``CtxPredLikelihoodModel.forward``, ``utils/network.py:4414-4465``: the
    rate form follows the *kernel* phase — noisy at q=1, rounded at q=2).

    Returns ``(x_rounded, bits)`` where ``bits`` has the same shape as ``x``
    (per-element rate; sum for the reference's total).
    """
    x_rounded = bypass_round(x)
    if spec.entropy_mode in CTX_MODES:
        if mode == "train" and q == 1:
            if key is None:
                raise ValueError("train-mode entropy bottleneck needs a PRNG key")
            nkey, pkey = jax.random.split(key)
            noise = jax.random.uniform(nkey, x.shape, x.dtype, -0.5, 0.5)
            x_form = x + noise
        else:
            x_form = x_rounded
            pkey = key
        pred_in = (
            jax.lax.stop_gradient(x_rounded) if spec.ctx_detach_pred else x_rounded
        )
        mu, sigma = ctx_pred_apply(spec, params, pred_in, q, pkey)
        bits = rate.gaussian_bits(x_form, sigma, mu, step=1.0)
        return x_rounded, bits

    if mode == "train":
        if key is None:
            raise ValueError("train-mode entropy bottleneck needs a PRNG key")
        noise = jax.random.uniform(key, x.shape, x.dtype, -0.5, 0.5)
        x_form = x + noise
    else:
        x_form = x_rounded
    if spec.entropy_mode == "gmm":
        bits = rate.gmm2_bits(x_form, params["entropy"], step=1.0)
    elif spec.entropy_mode == "factorized":
        bits = rate.factorized_bits(x_form, params["entropy"], step=1.0)
    else:
        sigma = jnp.abs(params["entropy"]["sigma"])
        mu = params["entropy"]["mu"]
        bits = rate.gaussian_bits(x_form, sigma, mu, step=1.0)
    return x_rounded, bits


def decoder_apply(
    spec: ModelSpec,
    params: dict,
    latent: jnp.ndarray,
    q: int,
    key: Optional[jax.Array] = None,
    aux: bool = True,
    compute_dtype=None,
):
    """CompDecoder forward (reference ``utils/network.py:4758-4779``).

    Returns ``(occupancy (B,32,32,32,1), cls_list [8^3, 16^3, 32^3], net_bits (7,))``.

    With ``aux=False`` (the decode-only path) the training-only heads and the
    weight-rate model are skipped, so the params pytree may omit
    ``conv0_cls``/``conv1_cls``/``wrate`` — the transmitted pack carries only
    what reconstruction needs (the reference instead ships its aux params in
    the fp32 as-is pool and loads ``strict=False``, ``NVFPCC.py:577-583``).

    ``compute_dtype`` (training-only knob, never part of the pack format):
    "bf16" runs the conv arithmetic in bfloat16 while master
    params, STE rounding and all rate/loss math stay f32 (see
    ``ops.conv._cast3``). Activations stay in the compute dtype between
    layers; every pre-sigmoid logit is cast back to f32 so the focal-loss
    logs keep full precision.
    """
    if latent.ndim != 5 or latent.shape[1:] != (2, 2, 2, spec.ch):
        raise ValueError(
            f"latent must be (B, 2, 2, 2, {spec.ch}), got {latent.shape}"
        )
    cd = compute_dtype
    dp = params["decoder"]
    if q == 1:
        keys = jax.random.split(key, 7)
        kk = dict(zip(TRANSMITTED_KERNELS, keys))
    else:
        kk = {n: None for n in TRANSMITTED_KERNELS}

    relu = jax.nn.relu
    # Only the mixed-precision TRAIN path casts logits back to f32. The bf16
    # DECODE path (codec._bf16_twin_spec: bf16 params, compute_dtype unset)
    # must keep its all-bf16 flow — its numerics are a measured, shipped
    # behavior (pack recon_dtype, RESULTS.md bf16 decision).
    f32 = (lambda t: t.astype(jnp.float32)) if qc.as_compute_dtype(cd) else (lambda t: t)
    out = qc.qconv_transpose3d(spec.specs["up0"], dp["up0"], latent, q, kk["up0"], cd)
    out = gdn.igdn_apply(dp["igdn"], out)
    out = relu(qc.qconv_transpose3d(spec.specs["conv0"], dp["conv0"], out, q, kk["conv0"], cd))
    cls0 = (
        jax.nn.sigmoid(f32(qc.iconv3d(spec.specs["conv0_cls"], dp["conv0_cls"], out, cd)))
        if aux
        else None
    )
    out = relu(qc.qconv_transpose3d(spec.specs["up1"], dp["up1"], out, q, kk["up1"], cd))
    out = relu(qc.qconv3d(spec.specs["conv1"], dp["conv1"], out, q, kk["conv1"], cd))
    cls1 = (
        jax.nn.sigmoid(f32(qc.iconv3d(spec.specs["conv1_cls"], dp["conv1_cls"], out, cd)))
        if aux
        else None
    )
    out = relu(qc.qconv_transpose3d(spec.specs["up2"], dp["up2"], out, q, kk["up2"], cd))
    out = relu(qc.qconv3d(spec.specs["conv2"], dp["conv2"], out, q, kk["conv2"], cd))
    out = qc.qconv3d(spec.specs["conv2_cls"], dp["conv2_cls"], out, q, kk["conv2_cls"], cd)
    out = jax.nn.sigmoid(f32(out))

    if not aux:
        return out, [None, None, out], jnp.zeros((len(TRANSMITTED_KERNELS),), jnp.float32)
    net_bits = jnp.stack(
        [
            rate.scalar_gaussian_rate(dp["wrate"], bypass_round16(dp[n]["kernel"]))
            for n in TRANSMITTED_KERNELS
        ]
    )
    return out, [cls0, cls1, out], net_bits


def net_apply(
    spec: ModelSpec,
    params: dict,
    emb: jnp.ndarray,
    mode: str,
    q: int,
    key: Optional[jax.Array] = None,
    compute_dtype=None,
):
    """Full forward (reference ``Net.forward``, ``NVFPCC.py:41-45``).

    Returns ``(occupancy, cls_list, net_bits (7,), latent_bits (B,))`` with
    per-block latent rate (sum over blocks for the reference's total — kept
    per block so padded batches can be masked under jit).

    ``compute_dtype``: see :func:`decoder_apply`. The latent generator,
    entropy bottleneck and all rate math stay f32 regardless — the latents
    and the ctx predictor are coding-path numerics (host parity contracts),
    and the 2^3-shaped latent ops are negligible compute.
    """
    if key is not None:
        ekey, dkey = jax.random.split(key)
    else:
        ekey = dkey = None
    latent = latent_gen_apply(spec, params, emb)
    latent_rounded, bits = entropy_apply(spec, params, latent, mode, ekey, q)
    latent_bits = bits.reshape(bits.shape[0], -1).sum(axis=1)
    out, cls_list, net_bits = decoder_apply(
        spec, params, latent_rounded, q, dkey, compute_dtype=compute_dtype
    )
    if spec.entropy_mode in CTX_MODES:
        # the transmitted ctx kernels' rate joins the network rate
        # (reference CtxPredLikelihoodModel.get_net_bits, utils/network.py:4460-4464)
        net_bits = jnp.concatenate([net_bits, ctx_kernel_bits(spec, params)])
    return out, cls_list, net_bits, latent_bits


def reconstruct(spec: ModelSpec, params: dict, latent: jnp.ndarray, q: int = 2):
    """Decode-only path (reference ``Net.reconstruct``, ``NVFPCC.py:47-49``).

    Works with the decode-minimal params pytree (no aux heads / wrate)."""
    out, _, _ = decoder_apply(spec, params, latent, q, aux=False)
    return out


def ctx_kernel_bits(spec: ModelSpec, params: dict) -> jnp.ndarray:
    """(2,) rate of the MASKED (i.e. transmitted) ctx kernel entries under
    the weight-rate model. Taps the causal mask zeroes never affect the
    output, so they are neither coded nor counted."""
    wrate = params["decoder"]["wrate"]
    bits = []
    for n in CTX_KERNELS:
        k = params["entropy"][n]["kernel"].reshape(-1)
        idx = spec.specs[n].mask_flat_indices
        bits.append(rate.scalar_gaussian_rate(wrate, bypass_round16(k[idx])))
    return jnp.stack(bits)


def get_latent_code(spec: ModelSpec, params: dict, emb: jnp.ndarray) -> dict:
    """Export quantized latents + entropy-model params for the range coder
    (reference ``Net.get_latent_code``, ``NVFPCC.py:60-71``). In ctx mode the
    coder derives per-symbol tables itself (host, integer-exact) from the
    rounded latents + transmitted ctx params, so only the latents export."""
    latent = latent_gen_apply(spec, params, emb)
    rounded, bits = entropy_apply(spec, params, latent, mode="eval")
    out = {"quantized_latent": rounded, "latent_bits": bits.sum()}
    if spec.entropy_mode in ("channel", "spatio"):
        out["sigma"] = jnp.abs(params["entropy"]["sigma"])
        out["mu"] = params["entropy"]["mu"]
    return out


def get_network_bits(spec: ModelSpec, params: dict) -> float:
    """Signaled network size estimate in bits (reference ``Net.get_network_bits``
    + ``CompDecoder.get_bits``, ``utils/network.py:4794-4799``: kernel-residual
    rate plus a fixed fp32 accounting of the as-is aux params; we mirror the
    reference's aux formula for metric parity)."""
    dp = params["decoder"]
    net_bits = sum(
        float(rate.scalar_gaussian_rate(dp["wrate"], bypass_round16(dp[n]["kernel"])))
        for n in TRANSMITTED_KERNELS
    )
    c = spec.channels
    aux_bits = sum(c[i] * 2 for i in (1, 2, 3)) * 32 + 32 + (c[1] ** 2 + c[1]) * 32
    if spec.entropy_mode in CTX_MODES:
        # masked ctx kernel residual rate + fp32 ctx biases; no sigma/mu table
        entropy_bits = float(ctx_kernel_bits(spec, params).sum())
        entropy_bits += (spec.ctx_hidden + 2 * spec.ch) * 32
    elif spec.entropy_mode in ("gmm", "factorized"):
        n_entropy = sum(int(np.prod(np.shape(v))) for v in params["entropy"].values())
        entropy_bits = n_entropy * 32  # all entropy-model leaves ship fp32
    else:
        n_entropy = spec.ch if spec.entropy_mode == "channel" else int(np.prod(spec.latent_shape))
        entropy_bits = n_entropy * 2 * 32  # sigma+mu fp32 (QuantGaussianLikelihood.get_bits)
    return net_bits + aux_bits + entropy_bits


def count_transmitted_residuals(spec: ModelSpec) -> int:
    """Number of coded residual weights (~51.4k at the reference config)."""
    return int(sum(np.prod(spec.specs[n].kernel_shape) for n in TRANSMITTED_KERNELS))
