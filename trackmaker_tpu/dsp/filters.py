"""FIR filtering, box smoothing, EMA power — vectorized.

The reference's receivers use (a) an exponential moving-average power
tracker ``p = p(1-1/64) + x²/64`` (examples/ask.rs:374-376), (b) an 11-tap
edge-truncated box smoother for coherent demod (ask.rs:418-432), and (c)
plain FIR band-limits elsewhere.  The EMA recurrence is a first-order
linear recurrence — an ``associative_scan``, not a loop — and the box
smoother is a box convolution divided by an edge-aware tap count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fir_filter(x: jax.Array, taps: jax.Array, mode: str = "same") -> jax.Array:
    """FIR filter along the last axis.  mode: 'same' | 'valid' | 'full'."""
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    l = taps.shape[0]
    if mode == "same":
        lo = (l - 1) // 2
        hi = l - 1 - lo
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(lo, hi)])
    elif mode == "full":
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(l - 1, l - 1)])
    elif mode == "valid":
        xp = x
    else:
        raise ValueError(mode)
    out = jax.lax.conv_general_dilated(
        xp.reshape(-1, 1, xp.shape[-1]),
        taps.reshape(1, 1, -1).astype(x.dtype),
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(*batch_shape, out.shape[-1])


def box_smooth_truncated(x: jax.Array, half: int = 5) -> jax.Array:
    """Edge-truncated centered moving average: out[j] = mean of
    x[max(0,j-half) : min(n, j+half+1)] (examples/ask.rs:421-431)."""
    n = x.shape[-1]
    w = 2 * half + 1
    sums = fir_filter(x, jnp.ones(w, x.dtype), mode="same")
    idx = jnp.arange(n)
    counts = (jnp.minimum(idx + half + 1, n) - jnp.maximum(idx - half, 0))
    return sums / counts.astype(x.dtype)


def ema_power(x: jax.Array, alpha: float = 1.0 / 64.0,
              block: int = 512) -> jax.Array:
    """p[i] = (1-alpha) p[i-1] + alpha x[i]² with p[-1]=0.

    Blocked formulation: within each `block`, the recurrence is one
    matmul against a lower-triangular decay matrix; across
    blocks, only the block-end values chain — a tiny associative scan
    over T/block elements.  A flat ``associative_scan`` over the full
    axis computes the same thing but its XLA graph grows superlinearly
    with batch x length, and so does its compile time.  The decay floor
    within a block is (1-alpha)^block ~= 3e-4 at the defaults — far
    above f32 denormals."""
    t = x.shape[-1]
    nb = -(-t // block)
    y = (x.astype(jnp.float32) ** 2)
    yp = jnp.pad(y, [(0, 0)] * (x.ndim - 1) + [(0, nb * block - t)])
    yp = yp.reshape(*x.shape[:-1], nb, block)
    j = jnp.arange(block, dtype=jnp.float32)[:, None]
    i = jnp.arange(block, dtype=jnp.float32)[None, :]
    m = jnp.where(j <= i, alpha * (1.0 - alpha) ** (i - j), 0.0)
    p_local = jnp.matmul(yp, m, precision=jax.lax.Precision.HIGHEST)
    e = p_local[..., -1]                                # (..., nb)
    decay = jnp.full(e.shape, (1.0 - alpha) ** block, jnp.float32)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    _, c = jax.lax.associative_scan(combine, (decay, e), axis=-1)
    c_prev = jnp.concatenate(
        [jnp.zeros_like(c[..., :1]), c[..., :-1]], axis=-1)
    tail = (1.0 - alpha) ** (jnp.arange(block, dtype=jnp.float32) + 1.0)
    p = p_local + c_prev[..., None] * tail
    return p.reshape(*x.shape[:-1], nb * block)[..., :t]


def sinc_lowpass_taps(num_taps: int, cutoff_hz: float,
                      sample_rate: int) -> jax.Array:
    """Hamming-windowed sinc low-pass (for band-limited channel models)."""
    m = num_taps - 1
    n = jnp.arange(num_taps) - m / 2.0
    fc = 2.0 * cutoff_hz / sample_rate
    h = jnp.where(n == 0, fc, fc * jnp.sinc(fc * n))
    w = 0.54 - 0.46 * jnp.cos(2.0 * jnp.pi * jnp.arange(num_taps) / m)
    taps = h * w
    return taps / jnp.sum(taps)


def bandpass_taps(num_taps: int, lo_hz: float, hi_hz: float,
                  sample_rate: int) -> jax.Array:
    """Windowed-sinc band-pass = highpass ∘ lowpass difference."""
    lp_hi = sinc_lowpass_taps(num_taps, hi_hz, sample_rate)
    lp_lo = sinc_lowpass_taps(num_taps, lo_hz, sample_rate)
    return lp_hi - lp_lo
