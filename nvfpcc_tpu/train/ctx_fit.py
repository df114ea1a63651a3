"""Post-hoc context-predictor fitting ("ctx_post"): entropy-upgrade a trained
model without touching its latents.

Capability target: the reference's dormant context stack
(``/root/reference/utils/network.py:4312-4465``) used the way the paper family
intends — conditional entropy coding of the latent field. Round 2 measured
that CO-TRAINING the predictor (entropy_mode=ctx_ar) warps latents toward
predictability at a ~1 dB reconstruction cost at vox11 (RESULTS.md). This
module instead fits the masked-conv predictor AFTER training, on the frozen
rounded latents:

- reconstruction is untouched (same latents, same decoder, same D1 — the
  pack's distortion point is exactly the source checkpoint's),
- the predictor minimizes the *actual* discrete coding objective (Gaussian
  bits of the already-rounded integers) plus the transmitted-kernel cost,
- the fitted kernels ship in the standard ctx/ctx_ar pack payload
  (docs/FORMAT.md §Context model) — the decoder cannot tell how the
  predictor was trained, so no format change is needed.

The fit is quantization-aware (kernels STE-round to the 1/16 grid inside the
forward, as in training) and runs as ONE jitted ``lax.scan`` program on the
CPU backend — thousands of tiny full-batch Adam steps would otherwise pay a
device round-trip each (CLAUDE.md environment facts).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nvfpcc_tpu.models import decoder as M
from nvfpcc_tpu.ops import rate
from nvfpcc_tpu.ops.ste import bypass_round16


# the structured predictor init lives with the model; it is the POST-HOC fit
# init only — co-training measurably does better from the reference's zero
# init (see init_params), so training does not use it
feature_init_ctx = M.ctx_feature_init


def fit_ctx_predictor(
    spec: M.ModelSpec,
    lat_int: np.ndarray,
    wrate: Optional[dict] = None,
    steps: int = 3000,
    lr: float = 3e-2,
    finetune_steps: int = 1000,
    finetune_lr: float = 2e-3,
    payload_weight: float = 1.0,
    init_entropy: Optional[dict] = None,
    early_stop: float = 2e-3,
    early_stop_patience: int = 2,
    backend: Optional[str] = None,
    log: Callable[[str], None] = print,
) -> dict:
    """Fit the spec's masked-conv predictor on frozen integer latents.

    ``spec`` must be a ctx-mode spec (``entropy_mode`` in ``CTX_MODES``);
    ``lat_int`` is the (N, 2, 2, 2, ch) rounded latents of the trained model.
    Two phases: an unquantized (q=0) fit from :func:`feature_init_ctx` with a
    cosine-decayed lr, then a quantization-aware (q=2, STE) finetune — the
    recipe that reaches near the linear-conditional bound where single-phase
    Adam from the standard init stalls at the marginal rate (see
    ``feature_init_ctx``). ``wrate`` (the checkpoint's trained scalar-Gaussian
    weight-rate params) prices the transmitted kernel residuals so the fit
    optimizes TOTAL pack bits; ``init_entropy`` warm-starts instead of the
    feature init (e.g. refitting a co-trained ctx checkpoint). Returns the
    fitted entropy subtree (float; codec quantizes to the 1/qp grid).

    ``early_stop``: end a phase when ``early_stop_patience`` CONSECUTIVE
    250-step chunks each improve the stream-bit estimate by less than this
    relative fraction (measured: some fits converge within the first chunk —
    the full 3000 steps were pure waste there). Patience matters: the
    two-masked-layer objective improves in bursts (vox11 l200 h16 measured
    chunk-over-chunk gains of <0.2% followed by >1% chunks; single-chunk
    stopping left +9% latent rate on the table there, RESULTS.md round 3).
    ``backend``: device platform for the fit (default None = the session's
    default device); any result is a valid pack (the fitted kernels are
    host-quantized and shipped), so the backend is purely a wall-clock choice.
    """
    if spec.entropy_mode not in M.CTX_MODES:
        raise ValueError(f"ctx_post needs a ctx-mode spec, got {spec.entropy_mode}")
    x = jnp.asarray(np.asarray(lat_int, np.float32))
    if init_entropy is not None:
        ep0 = {k: dict(init_entropy[k]) for k in M.CTX_KERNELS}
    else:
        ep0 = feature_init_ctx(spec)
    if wrate is not None:
        wrate = jax.tree_util.tree_map(
            lambda a: jax.lax.stop_gradient(jnp.asarray(a)), wrate
        )

    mask_idx = {n: spec.specs[n].mask_flat_indices for n in M.CTX_KERNELS}

    def objective(ep, q):
        mu, sigma = M.ctx_pred_apply(spec, {"entropy": ep}, x, q=q)
        bits = rate.gaussian_bits(x, sigma, mu, step=1.0).sum()
        payload = 0.0
        if wrate is not None:
            for n in M.CTX_KERNELS:
                k = ep[n]["kernel"].reshape(-1)[mask_idx[n]]
                payload = payload + rate.scalar_gaussian_rate(
                    wrate, bypass_round16(k)
                )
        return bits + payload_weight * payload, bits

    chunk = 250

    def run_phase(ep, q, n_steps, peak_lr, tag):
        opt = optax.adam(optax.cosine_decay_schedule(peak_lr, max(n_steps, 1)))
        opt_state = opt.init(ep)

        @jax.jit
        def run_chunk(ep, opt_state):
            def step(carry, _):
                ep, opt_state = carry
                (_, bits), grads = jax.value_and_grad(
                    lambda p: objective(p, q), has_aux=True
                )(ep)
                updates, opt_state = opt.update(grads, opt_state, ep)
                ep = optax.apply_updates(ep, updates)
                return (ep, opt_state), bits

            (ep, opt_state), bits = jax.lax.scan(
                step, (ep, opt_state), None, length=chunk
            )
            return ep, opt_state, bits[-1]

        prev = None
        below = 0
        n_chunks = max(1, n_steps // chunk)
        for c in range(n_chunks):
            ep, opt_state, bits = run_chunk(ep, opt_state)
            bits = float(bits)
            if c == 0 or c + 1 == n_chunks or (c + 1) % 4 == 0:
                log(
                    f"[ctx_fit] {tag} chunk {c + 1}/{n_chunks}: "
                    f"~{bits:.0f} stream bits"
                )
            if (
                early_stop
                and prev is not None
                and bits > prev * (1.0 - early_stop)
            ):
                # improvement comes in bursts (see docstring): one flat chunk
                # does not mean converged — require a run of them
                below += 1
                if below >= early_stop_patience:
                    log(
                        f"[ctx_fit] {tag} converged at chunk "
                        f"{c + 1}/{n_chunks} ({below} chunks "
                        f"<{early_stop:.1%} improvement), stopping early"
                    )
                    break
            else:
                below = 0
            prev = bits
        return ep

    dev = (
        jax.local_devices(backend=backend)[0]
        if backend
        else jax.local_devices()[0]
    )
    # f32-exact matmuls regardless of backend: a reduced-precision default
    # (bf16 passes on some accelerators, TF32 on the GPU) measurably degrades
    # the fitted rate (vox11 l200 h16 full fit: 3.617 b/sym at bf16-pass
    # precision vs 3.586 at f32, RESULTS.md round 3). The fit's convs are
    # tiny (94k syms at vox11), so the speed cost is noise; on CPU this is a
    # no-op.
    with jax.default_device(dev), jax.default_matmul_precision("highest"):
        ep = jax.device_put(ep0, dev)
        _, bits0 = objective(ep, 2)
        log(
            f"[ctx_fit] {spec.entropy_mode} hidden={spec.ctx_hidden}: start "
            f"{float(bits0):.0f} stream bits on {lat_int.shape[0]} blocks"
        )
        ep = run_phase(ep, 0, steps, lr, f"phase 1 (q0, {steps} steps)")
        if finetune_steps:
            ep = run_phase(
                ep, 2, finetune_steps, finetune_lr,
                f"phase 2 (q2 STE, {finetune_steps} steps)",
            )
    return jax.device_get(ep)


def latents_from_checkpoint(
    spec: M.ModelSpec, params: dict, emb: np.ndarray
) -> np.ndarray:
    """Rounded integer latents of a trained (params, emb) pair — the exact
    values the codec will code (host rint of the device latent, as in
    ``codec.encode``)."""
    fn = jax.jit(lambda p, e: M.latent_gen_apply(spec, p, e))
    lat = fn(params, jnp.asarray(emb, jnp.float32))
    return np.rint(np.asarray(lat, np.float64)).astype(np.int64)


def upgrade_params_to_ctx(
    spec: M.ModelSpec,
    params: dict,
    emb: np.ndarray,
    steps: int = 3000,
    lr: float = 3e-2,
    early_stop: float = 2e-3,
    backend: Optional[str] = None,
    log: Callable[[str], None] = print,
) -> dict:
    """Return a params tree whose entropy subtree is a freshly fitted ctx
    predictor for ``spec`` (any source entropy mode; the decoder/latent_gen
    subtrees — and therefore the reconstruction — are untouched)."""
    lat_int = latents_from_checkpoint(spec, params, emb)
    # always start from the feature init, even when refitting an already-ctx
    # checkpoint: the co-trained predictor's basin is the measured-bad one
    # (it stalls near the marginal rate; see feature_init_ctx)
    ep = fit_ctx_predictor(
        spec,
        lat_int,
        wrate=params["decoder"].get("wrate"),
        steps=steps,
        lr=lr,
        early_stop=early_stop,
        backend=backend,
        log=log,
    )
    out = dict(params)
    out["entropy"] = ep
    return out
