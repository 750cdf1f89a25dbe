"""The correlator (sync/correlate.py) vs a float64 NumPy reference, and
its per-128-lag-row hit contract."""

import numpy as np
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.phy.line_coding import preamble_waveform
from trackmaker_tpu.sync.correlate import normalized_xcorr, xcorr_hit_rows
from trackmaker_tpu.dsp.osc import chirp_np

# f32 correlation of unit-scale windows vs float64: a few ulps of the
# O(L) dot and energy sums, i.e. well under 1e-5 at full precision
TOL = 2e-5


def xcorr_f64(x, p, eps=1e-6):
    """Normalized sliding correlation in float64 (the reference's
    decoder.rs:123-238 definition, low-energy windows -> 0)."""
    x = np.asarray(x, np.float64)
    p = np.asarray(p, np.float64)
    w = np.lib.stride_tricks.sliding_window_view(x, len(p))
    dot = w @ p
    energy = np.sum(w * w, axis=-1)
    denom = np.sqrt(energy) * np.sqrt(np.sum(p * p))
    return np.where(energy < eps, 0.0, dot / np.maximum(denom, 1e-30))


@pytest.mark.parametrize("t", [2048, 5000, 100_000])
def test_kernel_matches_xla_manchester(t):
    cfg = PhyConfig()
    pre = preamble_waveform(cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, t).astype(np.float32)
    got = np.asarray(normalized_xcorr(jnp.asarray(x), jnp.asarray(pre)))
    want = xcorr_f64(x, pre)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


def test_kernel_matches_xla_long_pattern():
    """Chirp preamble (L=440), batched rows."""
    pre = chirp_np(440)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.5, (2, 20_000)).astype(np.float32)
    got = np.asarray(normalized_xcorr(jnp.asarray(x), jnp.asarray(pre)))
    for r in range(2):
        np.testing.assert_allclose(got[r], xcorr_f64(x[r], pre), atol=TOL)


def test_kernel_detects_preamble_peak():
    cfg = PhyConfig()
    pre = preamble_waveform(cfg)
    x = np.zeros(8192, np.float32)
    x[1000:1000 + len(pre)] = pre
    corr = np.asarray(normalized_xcorr(jnp.asarray(x), jnp.asarray(pre)))
    assert np.argmax(corr) == 1000
    assert corr[1000] > 0.999
    # low-energy clamp: silence regions are exactly 0
    assert corr[:100].max() == 0.0


def test_hit_rows_contract():
    """xcorr_hit_rows: per 128-lag row, the first rpb ascending hit
    positions, the true hit count, and the correlation at each hit —
    against the dense correlation, batched, with a tail-row hit."""
    cfg = PhyConfig()
    pre = preamble_waveform(cfg)
    rng = np.random.default_rng(2)
    t, b, thr = 40_000, 3, cfg.correlation_threshold
    x = rng.normal(0, 0.3, (b, t)).astype(np.float32)
    for row in range(b):
        for p in (1000 + 531 * row, 17000 + 113 * row, t - len(pre) - 7):
            x[row, p:p + len(pre)] += pre
    rows = np.asarray(xcorr_hit_rows(jnp.asarray(x), pre, thr))
    assert rows.shape == (b, -(-t // 128), 16)
    corr = np.asarray(normalized_xcorr(jnp.asarray(x), jnp.asarray(pre)))
    for row in range(b):
        hits = np.flatnonzero(corr[row] >= thr)
        assert len(hits) >= 3
        for r in range(rows.shape[1]):
            mine = hits[(hits >= 128 * r) & (hits < 128 * r + 128)]
            assert rows[row, r, 4] == len(mine)
            k = min(len(mine), 4)
            assert rows[row, r, :k].tolist() == mine[:k].tolist()
            assert (rows[row, r, k:4] == 2**30).all()
            vals = rows[row, r, 5:5 + k].view(np.float32)
            np.testing.assert_array_equal(vals, corr[row, mine[:k]])
            assert (rows[row, r, 9:] == 0).all()
