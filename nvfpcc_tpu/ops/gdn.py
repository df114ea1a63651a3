"""Generalized divisive normalization (GDN/IGDN) for 3-D feature grids.

Functional, channels-last rebuild of the reference ``gdn_3d.py:32-159``:
``y_o = x_o / sqrt(beta_o + sum_i gamma[o,i] * x_i^2)`` (GDN) and
``y_o = x_o * sqrt(...)`` (IGDN). Parameters are reparameterized as
``sqrt(v + pedestal)`` and clamped with the gradient-gated ``lower_bound``
(reference ``gdn_3d.py:50-95``).

Inputs are channels-last ``(..., C)``; the 1x1x1 conv of the reference is an
einsum over the channel axis, which XLA fuses with the surrounding
elementwise ops.
"""

from __future__ import annotations

import jax.numpy as jnp

from nvfpcc_tpu.ops.ste import lower_bound

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
BETA_BOUND = (BETA_MIN + PEDESTAL) ** 0.5
GAMMA_BOUND = REPARAM_OFFSET
GAMMA_INIT = 0.1


def gdn_init(ch: int) -> dict:
    """Initial GDN parameters (reference ``gdn_3d.py:50-69``).

    ``beta``: sqrt(1 + pedestal) per channel. ``gamma``: sqrt(0.1*I + pedestal),
    stored as a dense (out, in) matrix.
    """
    beta = jnp.sqrt(jnp.ones((ch,), jnp.float32) + PEDESTAL)
    gamma = jnp.sqrt(GAMMA_INIT * jnp.eye(ch, dtype=jnp.float32) + PEDESTAL)
    return {"beta": beta, "gamma": gamma}


def _norm_pool(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    beta = lower_bound(params["beta"], BETA_BOUND)
    beta = beta * beta - PEDESTAL
    gamma = lower_bound(params["gamma"], GAMMA_BOUND)
    gamma = gamma * gamma - PEDESTAL
    # reference computes conv3d(x^2, gamma[out, in, 1,1,1]) + beta
    norm = jnp.einsum("...i,oi->...o", x * x, gamma) + beta
    return jnp.sqrt(norm)


def gdn_apply(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """GDN: divide by the norm pool (reference ``gdn_3d.py:72-95``)."""
    return x / _norm_pool(params, x)


def igdn_apply(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """IGDN: multiply by the norm pool (reference ``gdn_3d.py:137-159``)."""
    return x * _norm_pool(params, x)
