"""Preamble synchronization: the correlator and its consumers."""

import jax
import numpy as _np

from trackmaker_tpu.sync.correlate import (  # noqa: F401
    normalized_xcorr,
    sliding_dot,
    sliding_dot_scaled,
    sliding_energy,
    xcorr_hit_rows,
    xcorr_row_stats,
)


def find_pattern_starts(rx, pattern_np, threshold: float,
                        max_frames: int = 64,
                        min_sep: int | None = None):
    """Generic threshold-crossing preamble finder: int32[max_frames]
    pattern starts (-1 padding), in order, separated by at least
    `min_sep` samples (default: one pattern length).  Callers decoding
    equal-length frames pass min_sep = frame_samples so in-body
    threshold crossings (line-coded data can correlate with the
    preamble at lowered thresholds) are consumed like the streaming
    decoders' cursor does.

    The OFDM receivers' chirp sync generalized to any host-constant
    pattern (Manchester/4B5B preambles for the coded PHYs' batched
    decode).  Same structure as `phy/ofdm.py:find_preambles` (which
    delegates here): block-bitmap first-crossing queries + aligned-row
    masked-argmax refine over one pattern span.  Traceable under
    jit/vmap/shard_map (the scan carry derives from rx)."""
    import jax.numpy as jnp
    from trackmaker_tpu.core import blockq

    pattern_np = _np.asarray(pattern_np, _np.float32)
    corr = normalized_xcorr(rx, pattern_np)
    t = corr.shape[-1]
    hits = corr >= threshold
    tables = blockq.block_tables(hits)
    w = len(pattern_np)
    sep = w if min_sep is None else int(min_sep)
    r_ = 512
    n_need = (w + r_ - 1) // r_ + 1
    nrows = -(-(t + w) // r_) + n_need
    rows = jnp.pad(corr, (0, nrows * r_ - t)).reshape(nrows, r_)
    lane = jnp.arange(n_need * r_, dtype=jnp.int32)

    def step(carry, _):
        cursor, done = carry
        first, has = blockq.first_set_from(tables, cursor)
        first = jnp.where(has, first, 0)
        jb, off = first // r_, first % r_
        win = jnp.concatenate([rows[jb + i] for i in range(n_need)])
        ok = (lane >= off) & (lane < off + w)
        peak = jb * r_ + jnp.argmax(jnp.where(ok, win, -jnp.inf))
        new_cursor = peak + sep
        out = jnp.where(has & ~done, peak, -1)
        return (jnp.where(has, new_cursor, cursor), done | ~has), out

    zero = (rx[0] * 0).astype(jnp.int32)
    (_, _), starts = jax.lax.scan(
        step, (zero, zero > 0), None, length=max_frames,
        unroll=min(8, max_frames))
    return starts
