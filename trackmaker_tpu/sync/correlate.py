"""Correlation-based preamble synchronization.

The reference scans one window at a time with an AVX dot product and an
incrementally-updated window energy (``src/phy/decoder.rs:123-238,358-417``).
Here the whole scan is a dense, parallel program: the sliding dot product
and the sliding window energy (the same product on the squared signal
against a box) are banded matrix products over rows of 128 lags, and the
normalized correlation is a fused elementwise epilogue.  Every product
runs at ``Precision.HIGHEST``: the 0.9 detection threshold is a
decision, and a reduced-precision pass (TF32 on a GPU) could move a
window across it.

This module is the one correlator of the package: the frame decoders,
the speculative decoder's hit rows and the equalizer's anchor search all
read it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST
_BIGI = np.int32(2**30)


def _banded_valid(x: jax.Array, k: jax.Array) -> jax.Array:
    """Valid-mode sliding correlation of x[..., T] with k[L] -> [..., T-L+1].

    With R the (rows, 128) row-major view of x, output row b (lags
    128b .. 128b+127) is sum_c R[b+c] @ P_c, where the band
    P_c[s, r] = k[128c + s - r] (zero off the band) — nch = 1 +
    ceil((L-1)/128) plain matrix products over shifted row views.  On
    an H100 this ran 5.9x faster than the same correlation as a
    1-channel XLA convolution (PERF.md, PR 1)."""
    l, t = k.shape[-1], x.shape[-1]
    n = t - l + 1
    nch = 1 + -(-(l - 1) // 128)
    rows = -(-n // 128)
    lead = x.shape[:-1]
    xp = jnp.pad(x, [(0, 0)] * len(lead) + [(0, (rows + nch) * 128 - t)])
    xp = xp.reshape(*lead, rows + nch, 128)
    j = (jnp.arange(128 * nch, dtype=jnp.int32)[:, None]
         - jnp.arange(128, dtype=jnp.int32)[None, :])
    band = jnp.where((j >= 0) & (j < l), k[jnp.clip(j, 0, l - 1)], 0.0)
    out = None
    for c in range(nch):
        term = jnp.einsum("...rs,sd->...rd", xp[..., c:c + rows, :],
                          band[128 * c:128 * (c + 1)], precision=_HI)
        out = term if out is None else out + term
    return out.reshape(*lead, rows * 128)[..., :n]


def sliding_dot(samples: jax.Array, pattern: jax.Array) -> jax.Array:
    """dot(samples[i:i+L], pattern) for every lag i (VALID)."""
    return _banded_valid(samples, pattern.astype(samples.dtype))


def sliding_energy(samples: jax.Array, window: int) -> jax.Array:
    """sum(samples[i:i+window]**2) for every lag i (VALID)."""
    ones = jnp.ones((window,), dtype=samples.dtype)
    return _banded_valid(samples * samples, ones)


def normalized_xcorr(
    samples: jax.Array,
    pattern: jax.Array,
    pattern_energy: float | jax.Array | None = None,
    eps: float = 1e-6,
) -> jax.Array:
    """Normalized sliding cross-correlation.

    corr[i] = dot(x[i:i+L], p) / (||x[i:i+L]|| * ||p||), with windows whose
    energy is below `eps` forced to 0 (the reference's low-energy skip,
    src/phy/decoder.rs:142-147).  Leading axes of `samples` batch.
    """
    pattern = jnp.asarray(pattern, jnp.float32)
    samples = jnp.asarray(samples, jnp.float32)
    l = pattern.shape[-1]
    if pattern_energy is None:
        pattern_energy = jnp.sqrt(jnp.sum(pattern ** 2))
    dot = sliding_dot(samples, pattern)
    energy = sliding_energy(samples, l)
    denom = jnp.sqrt(jnp.maximum(energy, 0.0)) * pattern_energy
    corr = jnp.where(energy < eps, 0.0, dot / jnp.maximum(denom, 1e-30))
    return corr


def preamble_energy(pattern: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.asarray(pattern, np.float64) ** 2)))


def _lag_rows(corr: jax.Array, n_rows: int, fill: float) -> jax.Array:
    """corr[..., N] -> [..., n_rows, 128] rows of 128 consecutive lags;
    lags past N read `fill`."""
    n = corr.shape[-1]
    pad = [(0, 0)] * (corr.ndim - 1) + [(0, n_rows * 128 - n)]
    return jnp.pad(corr, pad, constant_values=fill).reshape(
        *corr.shape[:-1], n_rows, 128)


def xcorr_hit_rows(samples: jax.Array, pattern: np.ndarray,
                   threshold: float, rpb: int = 4,
                   eps: float = 1e-6) -> jax.Array:
    """Threshold hits of the normalized correlation, per 128-lag row.

    Returns ``rows[..., ceil(T/128), 16]`` (int32) where row r's columns
    0..rpb-1 are the ascending absolute lag positions with
    ``corr >= threshold`` inside lags [128r, 128r+128) (padded with
    2^30), column rpb is the row's TRUE hit count (callers flag overflow
    when it exceeds rpb), columns rpb+1..2*rpb are the f32 correlation
    values at those hits bitcast to int32, and the rest are zero.  This
    is the row contract :func:`trackmaker_tpu.phy.spec_decode.
    _compact_hit_rows` compacts into a candidate table."""
    assert 2 * rpb + 1 <= 16
    pattern = np.asarray(pattern, np.float32)
    corr = normalized_xcorr(samples, jnp.asarray(pattern),
                            preamble_energy(pattern), eps)
    n_rows = -(-samples.shape[-1] // 128)
    c = _lag_rows(corr, n_rows, -np.inf)
    hit = c >= threshold
    lane = jnp.arange(128, dtype=jnp.int32)
    row_base = jnp.arange(n_rows, dtype=jnp.int32) * 128
    idxm = jnp.where(hit, lane, _BIGI)
    pos_cols, val_cols = [], []
    for _ in range(rpb):
        m = jnp.min(idxm, axis=-1)
        pos_cols.append(jnp.where(m < _BIGI, row_base + m, _BIGI))
        v = jnp.sum(jnp.where(lane == m[..., None], c, 0.0), axis=-1)
        val_cols.append(jax.lax.bitcast_convert_type(v, jnp.int32))
        idxm = jnp.where(lane > m[..., None], idxm, _BIGI)
    count = jnp.sum(hit.astype(jnp.int32), axis=-1)
    zeros = [jnp.zeros_like(count)] * (16 - 2 * rpb - 1)
    return jnp.stack(pos_cols + [count] + val_cols + zeros, axis=-1)


def xcorr_row_stats(samples: jax.Array, pattern: np.ndarray,
                    eps: float = 1e-6) -> tuple[jax.Array, jax.Array]:
    """(rowmax f32[R], rowpos i32[R]) — per-128-lag-row max of the
    normalized correlation and its absolute lag (first max wins ties),
    R = ceil((T-L+1)/128).  The equalizer's anchor search runs a top-k
    peel over these R-length vectors instead of argmax sweeps over the
    dense correlation."""
    pattern = np.asarray(pattern, np.float32)
    corr = normalized_xcorr(samples, jnp.asarray(pattern), None, eps)
    r = -(-corr.shape[-1] // 128)
    cm = _lag_rows(corr, r, -np.float32(3.4e38))
    rowmax = jnp.max(cm, axis=-1)
    rowpos = jnp.arange(r, dtype=jnp.int32) * 128 \
        + jnp.argmax(cm, axis=-1).astype(jnp.int32)
    return rowmax, rowpos


def sliding_dot_scaled(samples: jax.Array, pattern: np.ndarray,
                       scale: float) -> jax.Array:
    """Raw sliding dot(x[i-L+1..i], p)*scale aligned so lag i ends at
    sample i (left zero-history), length == len(samples).  The ASK
    receiver's sync correlator."""
    l = len(pattern)
    samples = jnp.asarray(samples, jnp.float32)
    padded = jnp.concatenate([jnp.zeros(l - 1, jnp.float32), samples])
    return sliding_dot(padded, jnp.asarray(pattern, jnp.float32)) * scale
