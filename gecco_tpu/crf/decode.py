"""Linear-chain CRF posterior decoding engines.

Computes, for batches of fixed-length windows over gene chains, the
per-position marginal probability of the positive label, replicating
CRFsuite's scaled forward–backward in probability space (the engine the
reference wraps via ``model.predict_marginals_single``,
``/root/reference/gecco/crf/__init__.py:250-258``):

* ``marginals_numpy`` — float64 host path mirroring CRFsuite's
  ``crf1d_context`` scaling order for numeric parity;
* ``marginals_jax``   — batched, jit-compiled device path (one ``lax.scan``
  forward, one backward, over a ``[B, W, L]`` window batch).

The sliding-window + element-wise max-pooling orchestration lives in
``windowed_max_probabilities``.
"""

import functools
from typing import Optional, Tuple

import numpy

__all__ = [
    "marginals_numpy",
    "marginals_jax",
    "windowed_max_probabilities",
]


def marginals_numpy(emissions: "numpy.ndarray", trans: "numpy.ndarray") -> "numpy.ndarray":
    """Forward–backward marginals for a batch of windows (float64, host).

    Arguments:
        emissions: ``[B, W, L]`` per-position state scores (log-space,
            i.e. sums of state-feature weights).
        trans: ``[L, L]`` transition weights (log-space).

    Returns:
        ``[B, W, L]`` posterior marginals.
    """
    emissions = numpy.asarray(emissions, dtype=numpy.float64)
    B, W, L = emissions.shape
    exp_state = numpy.exp(emissions)
    exp_trans = numpy.exp(numpy.asarray(trans, dtype=numpy.float64))

    alpha = numpy.empty((B, W, L))
    scale = numpy.empty((B, W))
    a = exp_state[:, 0, :].copy()
    s = a.sum(axis=1)
    scale[:, 0] = 1.0 / s
    a *= scale[:, 0, None]
    alpha[:, 0] = a
    for t in range(1, W):
        a = (a @ exp_trans) * exp_state[:, t, :]
        s = a.sum(axis=1)
        scale[:, t] = 1.0 / s
        a *= scale[:, t, None]
        alpha[:, t] = a

    beta = numpy.empty((B, W, L))
    b = numpy.broadcast_to(scale[:, W - 1, None], (B, L)).copy()
    beta[:, W - 1] = b
    for t in range(W - 2, -1, -1):
        b = (exp_state[:, t + 1, :] * b) @ exp_trans.T
        b *= scale[:, t, None]
        beta[:, t] = b

    marginals = alpha * beta / scale[:, :, None]
    return marginals


@functools.lru_cache(maxsize=None)
def _jit_marginals(window: int, labels: int):
    import jax
    import jax.numpy as jnp

    # NB: matmuls must NOT drop to bf16 on the MXU — marginals need full
    # f32; with L=2 these contractions are VPU-sized anyway.
    _dot = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def run(emissions, exp_trans):
        # emissions: [B, W, L] float32; exp_trans: [L, L]
        exp_state = jnp.exp(emissions)

        def fwd_step(a, e):
            a = _dot(a, exp_trans) * e
            s = 1.0 / a.sum(axis=-1, keepdims=True)
            a = a * s
            return a, (a, s[..., 0])

        a0 = exp_state[:, 0, :]
        s0 = 1.0 / a0.sum(axis=-1, keepdims=True)
        a0 = a0 * s0
        _, (alphas, scales) = jax.lax.scan(
            fwd_step, a0, jnp.moveaxis(exp_state[:, 1:, :], 1, 0)
        )
        alpha = jnp.concatenate([a0[None], alphas], axis=0)        # [W, B, L]
        scale = jnp.concatenate([s0[..., 0][None], scales], axis=0)  # [W, B]

        def bwd_step(b, inputs):
            e_next, s_t = inputs
            b = _dot(e_next * b, exp_trans.T)
            b = b * s_t[..., None]
            return b, b

        b_last = jnp.broadcast_to(scale[-1][..., None], a0.shape)
        _, betas = jax.lax.scan(
            bwd_step,
            b_last,
            (jnp.moveaxis(exp_state[:, 1:, :], 1, 0)[::-1], scale[:-1][::-1]),
        )
        beta = jnp.concatenate([b_last[None], betas], axis=0)[::-1]  # [W, B, L]

        marginals = alpha * beta / scale[..., None]
        return jnp.moveaxis(marginals, 0, 1)  # [B, W, L]

    return jax.jit(run)


def marginals_jax(emissions, trans, dtype=None):
    """Batched forward–backward marginals on the accelerator.

    Same contract as `marginals_numpy` but runs as a jitted pair of
    ``lax.scan`` passes over the whole window batch at once.
    """
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float32
    emissions = jnp.asarray(emissions, dtype=dtype)
    exp_trans = jnp.exp(jnp.asarray(trans, dtype=dtype))
    B, W, L = emissions.shape
    return _jit_marginals(W, L)(emissions, exp_trans)


def windowed_max_probabilities(
    emissions: "numpy.ndarray",
    trans: "numpy.ndarray",
    window: int,
    step: int,
    positive_index: int = 1,
    backend: str = "numpy",
) -> "numpy.ndarray":
    """Slide fixed windows over one chain and max-pool positive marginals.

    Replicates ``crf/__init__.py:250-258``: every window of size
    ``window`` advancing by ``step`` is decoded independently, and each
    position keeps the element-wise maximum of the positive-label
    marginal over all windows covering it.

    Arguments:
        emissions: ``[F, L]`` per-position state scores of one padded chain.
        trans: ``[L, L]`` transition weights.

    Returns:
        ``[F]`` max-pooled positive-label probabilities.
    """
    F, L = emissions.shape
    if F < window:
        raise ValueError("chain shorter than window; pad first")
    starts = numpy.arange(0, F - window + 1, step)
    index = starts[:, None] + numpy.arange(window)[None, :]
    windows = emissions[index]  # [B, W, L]
    if backend == "jax":
        marginals = numpy.asarray(marginals_jax(windows, trans))
    else:
        marginals = marginals_numpy(windows, trans)
    positive = marginals[:, :, positive_index]  # [B, W]
    out = numpy.zeros(F, dtype=positive.dtype)
    # scatter-max each window back onto the chain
    for b, start in enumerate(starts):
        segment = out[start : start + window]
        numpy.maximum(segment, positive[b], out=segment)
    return out
