"""Seeded, quantization-aware 3-D convolutions (channels-last layout).

Functional rebuild of the reference conv stack (``utils/network.py:564-742``):
every compressible layer splits its kernel into a deterministic seeded init
(regenerated by the decoder, never transmitted) plus a learned residual; only
the residual is quantized to the 1/16 grid and coded.

- ``QSpec``     — static layer description + seeded init buffers.
- ``conv_init`` — zero residual params ``{"kernel", "b"}``.
- ``qconv3d`` / ``qconv_transpose3d`` — quantization-aware forward:
  q=1 adds U(-Q/2, Q/2) noise to the residual (training proxy), q=2 rounds
  the residual to the 1/16 grid with an STE; then the seeded init is added
  back (reference ``QConv3d.forward`` / ``QConvTranspose3d.forward``,
  ``utils/network.py:606-623,673-688``).
- ``iconv3d``   — non-quantized seeded conv (reference ``IConv3d``,
  ``utils/network.py:690-742``).
- masked (causal) convs for the latent context model: a ``QSpec`` with a
  ``mask`` zeroes kernel taps at and after the center in raster order
  (reference ``QMaskedConv3d``, ``utils/network.py:4312-4379``); the mask is
  applied after the seeded init is added back, exactly as the reference does.

Layout: activations are NDHWC, kernels are stored ``(k, k, k, Cin, Cout)``
(DHWIO). Transposed convs are expressed as input-dilated convolutions with a
spatially flipped kernel, which XLA lowers to its convolution backend
(cuDNN on the GPU). Torch-equivalence (same math as the reference's
``F.conv3d`` / ``F.conv_transpose3d``) is covered by tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nvfpcc_tpu.ops.ste import bypass_round16
from nvfpcc_tpu.utils import seeds

_DN = ("NDHWC", "DHWIO", "NDHWC")


@dataclass(frozen=True)
class QSpec:
    """Static description of one (de)conv layer, including its seeded inits.

    ``kernel_init``/``b_init`` are deterministic functions of the seed tag and
    layer index — both encoder and decoder regenerate them, so they are never
    part of the transmitted payload (reference ``utils/network.py:588-600``).
    """

    kind: str  # "conv" | "conv_transpose"
    in_ch: int
    out_ch: int
    kernel_size: int
    stride: int = 1
    padding: int = 0
    output_padding: int = 0
    bias: bool = True
    iQ: int = 16
    kernel_init: np.ndarray = field(default=None, repr=False)
    b_init: np.ndarray = field(default=None, repr=False)
    # causal tap mask (k,k,k,1,1) or None; applied AFTER init is added back
    mask: np.ndarray = field(default=None, repr=False)

    @property
    def kernel_shape(self) -> Tuple[int, ...]:
        k = self.kernel_size
        return (k, k, k, self.in_ch, self.out_ch)

    @property
    def mask_flat_indices(self) -> np.ndarray:
        """Flat indices (into the C-order kernel) of the mask-visible taps —
        the only entries that affect the output, hence the only ones coded."""
        if self.mask is None:
            raise ValueError("not a masked conv")
        full = np.broadcast_to(self.mask, self.kernel_shape)
        return np.flatnonzero(full.reshape(-1))


def make_qspec(
    key: seeds.SeedKey,
    kind: str,
    in_ch: int,
    out_ch: int,
    kernel_size: int,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
    bias: bool = True,
    iQ: int = 16,
    zero_bias: bool = False,
) -> QSpec:
    """Build a layer spec with seeded Kaiming init buffers.

    Fan-in conventions mirror torch's generic fan computation on the
    reference's kernel layouts (``utils/network.py:377-391``): conv kernels
    (out, in, k^3) give fan_in = in*k^3; transposed kernels (in, out, k^3)
    give fan_in = out*k^3. Bias bound is 1/sqrt(in_ch) for both.
    """
    k = kernel_size
    kkey, bkey = seeds.sub_key(key, "kernel"), seeds.sub_key(key, "bias")
    if kind == "conv":
        fan_in = in_ch * k**3
    elif kind == "conv_transpose":
        fan_in = out_ch * k**3
    else:
        raise ValueError(f"unknown conv kind: {kind}")
    kernel_init = np.asarray(seeds.kaiming_uniform(kkey, (k, k, k, in_ch, out_ch), fan_in))
    if bias:
        if zero_bias:
            b_init = np.zeros((out_ch,), np.float32)
        else:
            b_init = np.asarray(seeds.uniform_bias(bkey, (out_ch,), in_ch))
    else:
        b_init = None
    return QSpec(
        kind=kind,
        in_ch=in_ch,
        out_ch=out_ch,
        kernel_size=kernel_size,
        stride=stride,
        padding=padding,
        output_padding=output_padding,
        bias=bias,
        iQ=iQ,
        kernel_init=kernel_init,
        b_init=b_init,
    )


def causal_mask(kernel_size: int) -> np.ndarray:
    """Strict raster-order causal mask (k,k,k,1,1): taps whose (d,h,w) offset
    is lexicographically before the center are 1, the center and everything
    after are 0 (reference mask construction, ``utils/network.py:4322-4329``).
    For inputs whose spatial extent is at most the raster stride this makes
    output position i depend only on input positions < i in C order."""
    if kernel_size % 2 != 1:
        raise ValueError("causal mask needs an odd kernel")
    k, h = kernel_size, kernel_size // 2
    m = np.zeros((k, k, k, 1, 1), np.float32)
    m[:h, :, :] = 1.0
    m[h, :h, :] = 1.0
    m[h, h, :h] = 1.0
    return m


def channel_ar_mask(
    kernel_size: int,
    in_ch: int,
    out_ch: int,
    in_group,
    out_group,
    center_strict: bool,
) -> np.ndarray:
    """Spatial causal mask PLUS a center tap gated by channel groups
    (PixelCNN-style channel autoregression over the latent channels):
    the center (same-position) tap from input unit i to output unit o is
    visible iff ``in_group(i) < out_group(o)`` (strict, first layer) or
    ``in_group(i) <= out_group(o)`` (second layer) — composed, (mu_c, sigma_c)
    see exactly the same-position channels strictly before c plus everything
    the spatial mask allows."""
    k, h = kernel_size, kernel_size // 2
    m = np.broadcast_to(causal_mask(kernel_size), (k, k, k, in_ch, out_ch)).copy()
    gi = np.asarray([in_group(i) for i in range(in_ch)])
    go = np.asarray([out_group(o) for o in range(out_ch)])
    if center_strict:
        center = gi[:, None] < go[None, :]
    else:
        center = gi[:, None] <= go[None, :]
    m[h, h, h] = center.astype(np.float32)
    return m


def make_masked_qspec(
    key: seeds.SeedKey,
    in_ch: int,
    out_ch: int,
    kernel_size: int = 3,
    iQ: int = 16,
    mask: Optional[np.ndarray] = None,
) -> QSpec:
    """Seeded causal masked conv (reference ``QMaskedConv3d``): stride 1,
    'same' padding, strict raster mask (or an explicit ``mask``, e.g. the
    channel-AR variant)."""
    base = make_qspec(
        key, "conv", in_ch, out_ch, kernel_size, 1, kernel_size // 2, iQ=iQ
    )
    return QSpec(
        kind=base.kind, in_ch=base.in_ch, out_ch=base.out_ch,
        kernel_size=base.kernel_size, stride=base.stride, padding=base.padding,
        output_padding=base.output_padding, bias=base.bias, iQ=base.iQ,
        kernel_init=base.kernel_init, b_init=base.b_init,
        mask=causal_mask(kernel_size) if mask is None else mask,
    )


def conv_init(spec: QSpec) -> dict:
    """Zero-residual trainable params (reference inits residuals to zero,
    ``utils/network.py:579-584``)."""
    params = {"kernel": jnp.zeros(spec.kernel_shape, jnp.float32)}
    if spec.bias:
        params["b"] = jnp.zeros((spec.out_ch,), jnp.float32)
    return params


def _effective_kernel(spec: QSpec, params: dict, q: int, key: Optional[jax.Array]):
    """Quantize the residual per phase ``q`` and add the seeded init back."""
    kernel = params["kernel"]
    if q == 1:
        if key is None:
            raise ValueError("q=1 (noise phase) requires a PRNG key")
        noise = jax.random.uniform(key, kernel.shape, kernel.dtype, -0.5, 0.5)
        k_rounded = kernel + noise * (1.0 / spec.iQ)
    elif q == 2:
        k_rounded = bypass_round16(kernel)
    else:
        k_rounded = kernel
    k_full = k_rounded + jnp.asarray(spec.kernel_init)
    if spec.mask is not None:
        k_full = k_full * jnp.asarray(spec.mask)
    return k_full


def _bias(spec: QSpec, params: dict):
    if not spec.bias:
        return None
    return params["b"] + jnp.asarray(spec.b_init)


def _conv(x, kernel, stride: int, padding: int):
    pad = [(padding, padding)] * 3
    return jax.lax.conv_general_dilated(
        x,
        kernel,
        window_strides=(stride,) * 3,
        padding=pad,
        dimension_numbers=_DN,
    )


def _conv_transpose(x, kernel, stride: int, padding: int, output_padding: int):
    """Torch conv_transpose3d semantics as an input-dilated conv.

    out = (in-1)*stride - 2*padding + k + output_padding. The kernel (stored
    DHWIO with I = the transpose op's input channels) is flipped spatially.
    """
    k = kernel.shape[0]
    lo = k - 1 - padding
    hi = k - 1 - padding + output_padding
    flipped = jnp.flip(kernel, axis=(0, 1, 2))
    return jax.lax.conv_general_dilated(
        x,
        flipped,
        window_strides=(1, 1, 1),
        padding=[(lo, hi)] * 3,
        lhs_dilation=(stride,) * 3,
        dimension_numbers=_DN,
    )


def as_compute_dtype(compute_dtype):
    """Normalize a compute-dtype knob: None/"f32" -> None (full precision),
    "bf16"/jnp.bfloat16 -> jnp.bfloat16."""
    if compute_dtype is None or compute_dtype in ("f32", "float32", jnp.float32):
        return None
    if compute_dtype in ("bf16", "bfloat16", jnp.bfloat16):
        return jnp.bfloat16
    raise ValueError(f"unsupported compute_dtype: {compute_dtype!r}")


def _cast3(x, kernel, b, compute_dtype):
    """Cast (activation, effective kernel, bias) to the compute dtype.

    Mixed-precision training contract: master residuals, quantization (STE
    rounding to the 1/16 grid) and the seeded-init add all happen in f32 in
    :func:`_effective_kernel`; only the *conv arithmetic* runs at the lower
    precision (bf16 operands, f32 accumulation in the conv backend). Casting
    the bias too keeps the activation in the compute dtype instead of silently
    promoting the whole chain back to f32 on the ``out + b`` add."""
    cd = as_compute_dtype(compute_dtype)
    if cd is None:
        return x, kernel, b
    return x.astype(cd), kernel.astype(cd), None if b is None else b.astype(cd)


def qconv3d(spec: QSpec, params: dict, x, q: int, key: Optional[jax.Array] = None,
            compute_dtype=None):
    """Quantization-aware conv (reference ``QConv3d.forward``)."""
    kernel = _effective_kernel(spec, params, q, key)
    x, kernel, b = _cast3(x, kernel, _bias(spec, params), compute_dtype)
    out = _conv(x, kernel, spec.stride, spec.padding)
    return out if b is None else out + b


def qconv_transpose3d(spec: QSpec, params: dict, x, q: int, key: Optional[jax.Array] = None,
                      compute_dtype=None):
    """Quantization-aware transposed conv (reference ``QConvTranspose3d.forward``)."""
    kernel = _effective_kernel(spec, params, q, key)
    x, kernel, b = _cast3(x, kernel, _bias(spec, params), compute_dtype)
    out = _conv_transpose(x, kernel, spec.stride, spec.padding, spec.output_padding)
    return out if b is None else out + b


def iconv3d(spec: QSpec, params: dict, x, compute_dtype=None):
    """Non-quantized seeded conv (reference ``IConv3d.forward``)."""
    kernel = params["kernel"] + jnp.asarray(spec.kernel_init)
    x, kernel, b = _cast3(x, kernel, _bias(spec, params), compute_dtype)
    out = _conv(x, kernel, spec.stride, spec.padding)
    return out if b is None else out + b
