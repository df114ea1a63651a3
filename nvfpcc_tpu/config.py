"""Experiment configuration dataclasses.

Mirrors the reference's flag surface (``NVFPCC.py:654-748``) plus the
module-level experiment constants (``NVFPCC.py:23-29``: Gaussian prob/param
models, 'wfocal' main loss, focal alpha 0.9).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class ModelConfig:
    ch: int = 3  # latent channels (--ch; README uses 3)
    chanstr: str = "8,16,8,8"  # decoder channel plan (--chanstr)
    seed_tag: str = "nvfpcc-tpu/seed-stream/v1"
    entropy_mode: str = "channel"
    """Latent entropy model granularity: "channel" = one (sigma, mu) per
    latent channel (the reference's active QuantGaussianLikelihood,
    utils/network.py:4490-4552); "spatio" = one per latent position
    (2,2,2,ch) (the dormant SpatioQuantGaussianLikelihood design,
    utils/network.py:4554-4590, with its self.bypass_round bug fixed);
    "ctx"/"ctx_ar" = autoregressive masked-conv context prediction;
    "gmm"/"factorized" = richer non-contextual models."""

    ctx_detach_pred: bool = False
    """ctx modes, training-only: stop the rate gradient at the context
    predictor's input (see ModelSpec.ctx_detach_pred). Does not affect the
    pack format."""

    ctx_hidden: int = 8
    """ctx modes: masked-conv predictor hidden width (8 matches the reference
    PredNet, utils/network.py:4385-4388). Travels in the pack model metadata
    (model.ctx_hidden) since the decoder must rebuild the same predictor."""

    ctx_tail: int = 0
    """ctx_ar only: the last ``ctx_tail`` of the ``ctx_hidden`` predictor
    units are payload-cheap tail units — full causal ctx1 taps, but readable
    by ctx2 only through the channel-gated center tap (~1/7 the transmitted
    taps per unit; see models.decoder.ModelSpec.ctx_tail). Format-visible:
    travels in the pack model metadata (absent = 0 keeps older packs
    decodable) and in checkpoint metadata."""

    ctx_train_init: str = "zero"
    """ctx modes, training-only (never format-relevant — the pack carries
    whatever kernels come out): predictor init for CO-TRAINING. "zero" is the
    reference behavior and the measured RD default — its optimization
    deadlock (the predictor learns sigma but never mu) is load-bearing: the
    big co-trained rate cuts come from the rate gradient warping latents
    toward predictability, and a WORKING predictor removes that pressure
    (RESULTS.md round 3, E1/E3). "feature" starts from the pass-through
    feature init instead (models.decoder.ctx_feature_init) — measured worse
    for co-training, kept for the decision artifact and for experimentation;
    it is the default for POST-HOC fits (train/ctx_fit.py), where it wins."""

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in self.chanstr.split(","))


@dataclass
class TrainConfig:
    lmbda: float = 200.0  # --lambda (README: 200)
    w1: float = 10.0  # latent-rate weight (README: 10)
    w2: float = 57.0  # network-rate weight (README: 57)
    wemb: float = 5.0  # embedding lr multiplier (README: 5)
    lr: float = 1e-3  # README: 1e-3
    batch_size: int = 16  # README: 16
    epochs: int = 501  # NVFPCC.py:128
    phase_change: int = 100  # q: 1 -> 2 at this epoch (NVFPCC.py:144-147)
    focal_alpha: float = 0.9  # NVFPCC.py:28
    ms_alpha: float = 0.85  # aux multiscale focal alpha (NVFPCC.py:166-171)
    beta: float = 1.0  # wfocal occupied-voxel weight (NVFPCC.py:184)
    sse_thh: float = 0.6  # train-time PSNR1 threshold (NVFPCC.py:192)
    milestones: Tuple[int, ...] = (300, 400, 450)  # MultiStepLR (NVFPCC.py:117)
    lr_decay: float = 0.1
    shuffle: str = "stride"  # "stride" (ref pseudo-shuffle idx*2113 % N), "random", "none"
    eval_every: int = 10  # eval + checkpoint cadence (NVFPCC.py:284)
    ref_sched_quirk: bool = False
    """Reproduce the reference scheduler bug (NVFPCC.py:126): both schedulers
    step the *net* optimizer, so the net lr decays twice (x0.01 per milestone)
    and the embedding lr never decays. Off by default (intended behavior)."""
    compute_dtype: str = "bf16"
    """Decoder-conv arithmetic precision during TRAINING: "bf16" (default —
    mixed precision; master params, STE rounding, latent entropy and loss
    math stay f32; only the 7-layer conv chain and its gradients run bf16)
    or "f32". Default flipped to bf16 in round 5 on the three-shape RD A/B:
    RD-dominant on sphere, on-or-above the f32 RD curve on torus/helix
    (RESULTS.md mixed-precision sections). Never part of
    the pack format: encode/decode always run the precision the pack declares
    (CodecConfig.recon_dtype). One caveat rides with bf16: XLA refuses convs
    differently across program layouts (epoch chunk boundaries, resume,
    GSPMD), so trajectory-equality guarantees (chunked == per-epoch,
    straight == resumed, mesh == single-device) are bitwise/ulp-exact only
    under f32; under bf16 they hold to bf16-ulp drift."""
    emb_chunks: int = 0
    """Block chunking for the once-per-epoch full-set embedding update.
    0 (default) = auto: one chunk up to 4096 blocks (every vox10 artifact —
    programs unchanged), then the smallest count keeping each chunk at or
    under 4096 blocks (vox11's 5326-block all-blocks conv activations alone
    are ~13 GB). The decomposition is exact (sums over
    blocks + a global rate normalizer, train/loop.py:make_emb_full_grad —
    exact for deterministic forms, i.e. ctx modes at q=2; noise draws differ
    per chunking but are statistically identical). Ignored under block-DP
    (the mesh already splits the update)."""
    seed: int = 0


@dataclass
class CodecConfig:
    thh_encode: float = 0.65  # README:55
    thh_decode: float = 0.64  # README:61
    qp: int = 16  # weight quantization (README "4-bit" residuals)
    depth: int = 10  # vox10
    level: int = 5  # octree partition level -> 32^3 blocks
    recon_dtype: str = "f32"
    """Reconstruction dtype, "f32" or "bf16". bf16 runs the decode chain in
    bfloat16 (~0.8% of thresholded voxels flip vs f32 — RESULTS.md); it rides
    in the pack so both sides run the identical program and rc_enc == rc_dec
    stays structural."""


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
