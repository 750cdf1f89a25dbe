"""Row-stats xcorr (anchor-search primitive) vs dense corr.

`xcorr_row_stats` feeds the equalizer's anchor peel
(dsp/equalizer.py): per-128-lag-row (max corr, arg position).  These
tests pin it against stats computed in NumPy from the dense normalized
correlation — including the first-max tie rule, the valid-lag mask on
the final partial row, and a short capture."""

import numpy as np
import jax.numpy as jnp

from trackmaker_tpu.sync.correlate import normalized_xcorr, xcorr_row_stats


def _dense_stats(x, pat):
    corr = np.asarray(normalized_xcorr(jnp.asarray(x), jnp.asarray(pat)))
    n = len(corr)
    r = -(-n // 128)
    cm = np.full((r * 128,), -np.float32(3.4e38), np.float32)
    cm[:n] = corr
    cm = cm.reshape(r, 128)
    return cm.max(axis=1), cm.argmax(axis=1) + np.arange(r) * 128


def test_rowstats_matches_dense():
    rng = np.random.default_rng(11)
    pat = np.sign(rng.normal(size=96)).astype(np.float32)
    x = rng.normal(0, 0.3, 40_000).astype(np.float32)
    for p0 in (500, 12_345, 39_000):          # incl. tail-row peak
        n = min(96, len(x) - p0)
        x[p0: p0 + n] += pat[:n]
    rm_k, rp_k = xcorr_row_stats(jnp.asarray(x), pat)
    rm_d, rp_d = _dense_stats(x, pat)
    r = len(rm_d)
    assert np.allclose(np.asarray(rm_k)[:r], rm_d, atol=1e-5)
    # positions must agree exactly wherever the row max is unambiguous
    # (ulp-level corr differences can flip argmax between near-equal
    # values; the injected peaks are unambiguous by construction)
    mism = np.flatnonzero(np.asarray(rp_k)[:r] != rp_d)
    for i in mism:
        row = np.asarray(normalized_xcorr(jnp.asarray(x),
                                          jnp.asarray(pat)))
        a, b = np.asarray(rp_k)[i], rp_d[i]
        assert abs(row[a] - row[b]) < 1e-5, (i, a, b)


def test_rowstats_ties_take_first():
    pat = np.ones(8, np.float32)
    x = np.zeros(1024, np.float32)
    x[100:108] = 1.0          # two identical windows in one lag row
    x[110:118] = 1.0
    rm, rp = xcorr_row_stats(jnp.asarray(x), pat)
    assert int(np.asarray(rp)[0]) == 100
    rm_d, rp_d = _dense_stats(x, pat)
    assert int(rp_d[0]) == 100


def test_rowstats_short_capture_cpu_dispatch():
    rng = np.random.default_rng(3)
    pat = np.sign(rng.normal(size=60)).astype(np.float32)
    x = rng.normal(0, 0.2, 700).astype(np.float32)
    x[300:360] += pat
    rm, rp = xcorr_row_stats(jnp.asarray(x), pat)
    j = int(np.argmax(np.asarray(rm)))
    assert int(np.asarray(rp)[j]) == 300
