"""Preamble-trained MMSE equalizer (dsp/equalizer.py) — beyond-parity
multipath front-end for the line-coded PHY.

The headline claim: a 2-path channel (echo amplitude 0.5, 7-sample
delay) that drops the stock decoder to 0 frames is fully recovered by
the equalizer.  The stock-decoder envelope (what survives WITHOUT an
equalizer) is pinned in test_multipath_phy.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.dsp.channel import multipath
from trackmaker_tpu.dsp.equalizer import (
    decode_capture_eq, equalize_capture, estimate_channel)
from trackmaker_tpu.oracle.phy import OracleEncoder
from trackmaker_tpu.phy.decoder import decode_capture


def _capture(cfg, taps, sigma=0.01, n=8, seed=0):
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * 40)
              for i in range(n)]
    parts = []
    for f in frames:
        parts.append(enc.encode_frame(f))
        parts.append(np.zeros(400, np.float32))
    wave = np.concatenate(parts + [np.zeros(600, np.float32)])
    echoed = np.asarray(multipath(jnp.asarray(wave), jnp.asarray(taps)))
    echoed = (echoed + rng.normal(0, sigma, len(echoed))).astype(
        np.float32)
    return echoed, sorted(f.data for f in frames)


def _payloads(res):
    return sorted(
        bytes(fb[7:7 + int(ln)])
        for fb, ln, ok in zip(np.asarray(res.frame_bytes),
                              np.asarray(res.length),
                              np.asarray(res.valid)) if ok)


@pytest.mark.parametrize("lc", [MANCHESTER, FOUR_B_FIVE_B])
def test_strong_echo_recovered(lc):
    """Echo 0.5 @ 7 samples: stock decoder gets nothing, equalized
    decode returns every frame."""
    cfg = PhyConfig(line_coding=lc)
    taps = np.zeros(8, np.float32)
    taps[0] = 1.0
    taps[7] = 0.5
    echoed, want = _capture(cfg, taps)
    n = len(want)
    stock = _payloads(decode_capture(cfg, jnp.asarray(echoed), 2,
                                     max_frames=n + 4))
    assert len(stock) < n        # the channel genuinely breaks stock
    eq = _payloads(decode_capture_eq(cfg, echoed, 2, max_frames=n + 4))
    assert eq == want


def test_acausal_echo_recovered():
    """The DELAYED path is the stronger one, so the anchor locks onto
    it and the direct path becomes an acausal tap — the K0 margin must
    bracket it (delay 11 < K0 = 16)."""
    cfg = PhyConfig()
    taps = np.zeros(12, np.float32)
    taps[0] = 0.6
    taps[11] = 1.0
    echoed, want = _capture(cfg, taps, sigma=0.005)
    eq = _payloads(decode_capture_eq(cfg, echoed, 2,
                                     max_frames=len(want) + 4))
    assert eq == want


def test_clean_channel_is_decision_neutral():
    """On a clean capture the equalizer trains on the (identity)
    channel and the decode must stay decision-for-decision equal."""
    cfg = PhyConfig()
    taps = np.zeros(1, np.float32)
    taps[0] = 1.0
    echoed, want = _capture(cfg, taps, sigma=0.02, seed=3)
    a = decode_capture(cfg, jnp.asarray(echoed), 2, max_frames=12)
    b = decode_capture_eq(cfg, echoed, 2, max_frames=12)
    assert _payloads(a) == _payloads(b) == want
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))


def test_noise_only_passes_through():
    """No preamble above quality 0.5 -> gate holds, output == input."""
    cfg = PhyConfig()
    rng = np.random.default_rng(7)
    noise = rng.normal(0, 0.1, 40_000).astype(np.float32)
    out, info = equalize_capture(cfg, jnp.asarray(noise))
    assert not bool(info["applied"])
    np.testing.assert_array_equal(np.asarray(out), noise)


def test_channel_estimate_matches_truth():
    """LS taps recover the simulated impulse response (within noise)."""
    cfg = PhyConfig()
    taps = np.zeros(10, np.float32)
    taps[0] = 1.0
    taps[4] = -0.4
    taps[9] = 0.3
    echoed, _ = _capture(cfg, taps, sigma=0.005)
    from trackmaker_tpu import sync as sync_mod
    from trackmaker_tpu.phy import line_coding
    pre = np.asarray(line_coding.preamble_waveform(cfg))
    corr = sync_mod.normalized_xcorr(jnp.asarray(echoed), pre)
    anchor = jnp.argmax(corr).astype(jnp.int32)
    h, lam = estimate_channel(cfg, jnp.asarray(echoed), anchor)
    h = np.asarray(h)
    from trackmaker_tpu.dsp.equalizer import K0
    est = h[K0:K0 + 10]
    assert np.max(np.abs(est - taps)) < 0.06
    assert float(lam) < 0.05


# ---------------------------------------------------------------------------
# Mid-burst captures: multi-anchor training + decision-directed refit


def _midburst_capture(taps_spec, sigma, cut_frac=0.6, n=8, seed=3):
    """Zero-gap burst with the capture head cut off mid-frame: every
    surviving preamble is preceded by the previous frame's tail, so the
    preamble-trained silent-lead-in model holds for NO anchor."""
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * 40)
              for i in range(n)]
    parts = [enc.encode_frame(f) for f in frames]
    flen = len(parts[0])
    wave = np.concatenate(parts + [np.zeros(600, np.float32)])
    nt = max(d for d, _ in taps_spec) + 1
    taps = np.zeros(nt, np.float32)
    taps[0] = 1.0
    for d, a in taps_spec:
        taps[d] = a
    ech = np.asarray(multipath(jnp.asarray(wave), jnp.asarray(taps)))
    rng = np.random.default_rng(seed)
    ech = (ech + rng.normal(0, sigma, len(ech))).astype(np.float32)
    ech = ech[int(flen * cut_frac):]
    want = sorted(f.data for f in frames[1:])
    return cfg, ech, want


def test_decision_directed_beats_both_bootstraps():
    """Echo 0.6 @ 9 on a mid-burst capture: the stock decoder gets a
    strict subset, the preamble-trained equalizer is WORSE than stock
    (its training window holds the previous frame's tail), and the
    decision-directed refit — trained on the interiors of the frames
    stock did decode — recovers every frame."""
    from trackmaker_tpu.dsp.equalizer import decode_capture_dd
    cfg, ech, want = _midburst_capture([(9, 0.6)], sigma=0.02)
    n = len(want)
    stock = _payloads(decode_capture(cfg, jnp.asarray(ech), 2,
                                     max_frames=n + 4))
    assert 1 <= len(stock) < n          # partial: bootstrap exists
    eq = _payloads(decode_capture_eq(cfg, ech, 2, max_frames=n + 4))
    assert len(eq) < n                  # mid-burst training can't win
    dd = _payloads(decode_capture_dd(cfg, ech, 2, max_frames=n + 4))
    assert dd == want


def test_decision_directed_never_below_bootstrap():
    """When the preamble-trained pass already fails to 0 and stock
    decodes everything (echo @ 9, moderate), dd returns the stock
    result — the bootstrap comparison guards against a corrupted
    equalization making things worse."""
    from trackmaker_tpu.dsp.equalizer import decode_capture_dd
    cfg, ech, want = _midburst_capture([(9, 0.5)], sigma=0.03)
    dd = _payloads(decode_capture_dd(cfg, ech, 2,
                                     max_frames=len(want) + 4))
    assert dd == want


def test_decision_directed_clean_channel_neutral():
    """Clean gapped capture: dd degenerates to the stock result."""
    from trackmaker_tpu.dsp.equalizer import decode_capture_dd
    cfg = PhyConfig()
    taps = np.zeros(1, np.float32)
    taps[0] = 1.0
    echoed, want = _capture(cfg, taps, sigma=0.02, seed=5)
    dd = _payloads(decode_capture_dd(cfg, echoed, 2,
                                     max_frames=len(want) + 4))
    assert dd == want


def test_multianchor_picks_the_gap_following_anchor():
    """An attenuated first frame is the ONLY one that follows silence;
    the burst behind it correlates more strongly (normalized xcorr is
    amplitude-blind, the weak frame just has lower SNR).  Single-anchor
    training locks onto a mid-burst peak and ruins the capture; the
    multi-anchor LS-residual vote picks the quiet-lead-in anchor (its
    lam is ~100x smaller) and the equalized decode returns all frames,
    beating stock."""
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * 40)
              for i in range(8)]
    w0 = enc.encode_frame(frames[0]) * 0.4
    rest = np.concatenate([enc.encode_frame(f) for f in frames[1:]])
    wave = np.concatenate([np.zeros(500, np.float32), w0, rest,
                           np.zeros(600, np.float32)])
    taps = np.zeros(10, np.float32)
    taps[0] = 1.0
    taps[9] = 0.6
    ech = np.asarray(multipath(jnp.asarray(wave), jnp.asarray(taps)))
    rng = np.random.default_rng(3)
    ech = (ech + rng.normal(0, 0.02, len(ech))).astype(np.float32)
    want = sorted(f.data for f in frames)

    eq1, info1 = equalize_capture(cfg, jnp.asarray(ech), n_anchors=1)
    n1 = len(_payloads(decode_capture(cfg, eq1, 2, max_frames=12)))
    eq4, info4 = equalize_capture(cfg, jnp.asarray(ech))
    got4 = _payloads(decode_capture(cfg, eq4, 2, max_frames=12))
    stock = _payloads(decode_capture(cfg, jnp.asarray(ech), 2,
                                     max_frames=12))
    assert n1 < len(want)                         # mid-burst anchor
    assert float(info4["lam"]) < 0.3 * float(info1["lam"])
    assert got4 == want
    assert len(stock) < len(want)


def test_anchor_near_capture_start_aligns():
    """A frame whose preamble starts at sample 0: the front-pad keeps
    the training window aligned (a bare clip used to shift it onto
    garbage) and the echoed capture still decodes."""
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * 40)
              for i in range(4)]
    parts = []
    for f in frames:
        parts.append(enc.encode_frame(f))
        parts.append(np.zeros(400, np.float32))
    wave = np.concatenate(parts + [np.zeros(600, np.float32)])
    taps = np.zeros(8, np.float32)
    taps[0] = 1.0
    taps[7] = 0.5
    ech = np.asarray(multipath(jnp.asarray(wave), jnp.asarray(taps)))
    rng = np.random.default_rng(1)
    ech = (ech + rng.normal(0, 0.01, len(ech))).astype(np.float32)
    want = sorted(f.data for f in frames)
    got = _payloads(decode_capture_eq(cfg, ech, 2, max_frames=8))
    assert got == want
