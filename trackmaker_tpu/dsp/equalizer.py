"""Preamble-trained MMSE equalizer — an opt-in multipath front-end for
the line-coded PHY.

The reference has no equalizer (its decoder fails on echoic channels the
same way ours does); this module
is beyond-parity capability.  Measured motivation (see
tests/test_equalizer.py): a 2-path channel with echo amplitude 0.5 at
7-sample delay drops the stock decoder from 8/8 to 0/8 frames; with this
front-end it decodes 8/8 again.

Design (one fixed-shape jit, vmap-able):

1. *Anchor*: the strongest normalized preamble correlation in the
   capture (per-128-lag-row maxima from sync.xcorr_row_stats).  Any
   frame's preamble works: the channel is LTI over a capture.
2. *Channel estimate*: LS fit of ``n_ch`` taps (with ``K0`` acausal
   margin, so an anchor locked onto either path still brackets the
   response) against the KNOWN preamble waveform.  The normal-equation
   solve folds into a single static host matrix: ``h = M @ rx_window``
   with ``M = (A^T A + eps I)^-1 A^T`` precomputed from the preamble —
   one tiny matmul at runtime, no linear solve on device.
3. *MMSE inversion*: ``G = conj(H) / (|H|^2 + lam)`` in the frequency
   domain, with ``lam`` the measured fit-residual-to-signal ratio (the
   actual noise level, not a guess), truncated to a two-sided FIR.
4. *Apply*: blocked banded matmul (slab rows x a Toeplitz band built
   from the traced taps) — the taps are traced values, so no
   host-side pattern is needed.
5. *Gate*: if the anchor quality is below ``min_quality`` (no clean
   preamble to train on), the capture passes through untouched.

The output feeds the UNMODIFIED decoder: oracle parity of
`decode_capture` is untouched; this is a pure pre-processing stage.
"""

from __future__ import annotations

import functools
import os as _os

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.phy import line_coding
from trackmaker_tpu import sync as sync_mod

N_CH = 48          # estimated channel taps
K0 = 16            # acausal taps (echo arriving before the anchor path)
N_FFT = 1024       # inversion FFT size
L_HALF = 192       # equalizer FIR: lags in [-L_HALF, L_HALF] (a 0.9
                   # echo at delay d inverts with time constant
                   # ~d/ln(1/0.9) samples; 192 covers d<=20 echoes)
BLK = 512          # apply-stage block width


@functools.lru_cache(maxsize=8)
def _ls_solver_np(cfg: PhyConfig) -> tuple[np.ndarray, np.ndarray,
                                           int, int]:
    """(M, A, i0, rows): h = M @ rx[anchor+i0 : anchor+i0+rows].

    Model: rx[anchor + i] = sum_k h[k] * s[i + K0 - k], where s is the
    transmit waveform aligned so s[0] = preamble[0] at the anchor, and
    the N_CH samples BEFORE the preamble are modeled as silence (true
    whenever the training frame follows an inter-frame gap or channel
    idle — the strongest-correlation anchor in a capture).  Including
    the silent lead-in is load-bearing twice over: it adds rows (the
    4B5B preamble alone is 60 samples — fewer equations than the 48
    unknowns) and the energy onset pins the direct-path delay, breaking
    the shift ambiguity of periodic preambles (Manchester's
    preamble-only Toeplitz is numerically rank-deficient, cond ~1e17).
    M folds the ridge-regularized normal-equation solve into one
    [N_CH, rows] constant; A reproduces the fit for the residual-based
    noise estimate."""
    pre = np.asarray(line_coding.preamble_waveform(cfg), np.float64)
    p = len(pre)
    s_ext = np.concatenate([np.zeros(N_CH), pre])   # s[j] = s_ext[j+N_CH]
    i_min = -K0 - 1
    i_max = p - K0 - 1
    rows = i_max - i_min + 1
    a = np.zeros((rows, N_CH), np.float64)
    for r in range(rows):
        for k in range(N_CH):
            a[r, k] = s_ext[i_min + r + K0 - k + N_CH]
    # the silent-lead-in rows make A well-conditioned (cond ~3e2), so
    # the ridge only needs to guard the noise floor, not the rank
    ata = a.T @ a + 1e-4 * np.eye(N_CH)
    m = np.linalg.solve(ata, a.T)
    return m.astype(np.float32), a.astype(np.float32), i_min, rows


def estimate_channel(cfg: PhyConfig, rx: jax.Array, anchor: jax.Array):
    """(h[N_CH], lam) — LS channel taps at `anchor` + the measured
    residual-to-signal ratio used as the MMSE noise loading.

    The capture is front-padded by K0+1 zeros so an anchor within K0+1
    samples of the capture start still aligns its training window (the
    zeros are genuine silence — the capture boundary); a bare clip used
    to SHIFT the window for such anchors, training on garbage.

    The window fetch is an aligned 128-row gather + exact lane realign
    (core.realign recipe) instead of a traced-start ``dynamic_slice``
    (per-element gathers under vmap).  ``shift_realign`` is
    f32-bit-exact, so ``b`` (and every downstream tap) is unchanged."""
    from trackmaker_tpu.core import realign
    m, a, i0, rows = _ls_solver_np(cfg)
    pad0 = K0 + 1                                    # -i0
    t = rx.shape[-1]
    rows8 = -(-rows // 8) * 8
    nrow = rows8 // 128 + 2
    total = -(-(pad0 + t + nrow * 128 + 128) // 128) * 128
    rx_pad = jnp.concatenate(
        [jnp.zeros(pad0, jnp.float32), rx,
         jnp.zeros(total - pad0 - t, jnp.float32)])
    grid = rx_pad.reshape(total // 128, 128)
    start = jnp.maximum(anchor + i0 + pad0, 0)
    q = jnp.floor_divide(start, 128)
    ridx = q + jnp.arange(nrow, dtype=jnp.int32)
    src = jnp.take(grid, ridx, axis=0, mode="clip").reshape(1, nrow * 128)
    b = realign.shift_realign(src, (start - 128 * q)[None], rows8)[0, :rows]
    hi = jax.lax.Precision.HIGHEST
    h = jnp.dot(jnp.asarray(m), b, precision=hi)
    fit = jnp.dot(jnp.asarray(a), h, precision=hi)
    res = jnp.mean((fit - b) ** 2)
    sig = jnp.maximum(jnp.mean(b ** 2), 1e-12)
    lam = jnp.clip(res / sig, 1e-4, 1.0)
    return h, lam


def _mmse_taps(h: jax.Array, lam: jax.Array) -> jax.Array:
    """Two-sided equalizer FIR g_t over lags [-L_HALF, L_HALF] from the
    frequency-domain MMSE inverse of h."""
    hf = jnp.fft.rfft(h, n=N_FFT)
    g = jnp.conj(hf) / (jnp.abs(hf) ** 2 + lam)
    g_full = jnp.fft.irfft(g, n=N_FFT)
    lags = np.arange(-L_HALF, L_HALF + 1) % N_FFT     # static indices
    return g_full[lags]


def _apply_fir(rx: jax.Array, g_t: jax.Array) -> jax.Array:
    """eq[n] = sum_lag g_t[lag + L_HALF] * rx[n - K0 - lag] as a blocked
    banded matmul (traced taps).

    128-wide blocks, four [nblk, 128] @ [128, 128] matmuls on shifted
    full-width ROW views: eq[128b + c] = sum_d p[d]
    xs[128b + c + d] with d < 385, and c + d < 512 spans exactly rows
    b..b+3, so B_s[u, c] = p[128s + u - c] (masked to the band).  At
    BLK=512 the dense band carried 57% structural zeros (2.3x FLOP
    waste) and the second operand was a lane-sliced copy; here every
    view is a whole-row slice (free) and utilization is 385/512 = 75%.
    f32 accumulation order differs from the old two-matmul split — eq
    is not bit-pinned across formulations; both spec and exact decoders
    consume the same eq buffer, so decisions stay internally
    consistent (as before)."""
    t = rx.shape[-1]
    l_gt = 2 * L_HALF + 1                    # 385
    bw = 128
    nblk = -(-t // bw)
    nrows = nblk + 4
    pad_l = L_HALF + K0
    xs = jnp.concatenate([jnp.zeros(pad_l, jnp.float32), rx,
                          jnp.zeros(nrows * bw - t - pad_l, jnp.float32)])
    rows = xs.reshape(nrows, bw)
    p = g_t[::-1]
    uu = jax.lax.broadcasted_iota(jnp.int32, (bw, bw), 0)
    cc = jax.lax.broadcasted_iota(jnp.int32, (bw, bw), 1)
    eq = None
    for s in range(4):
        d = s * bw + uu - cc
        band_s = jnp.where((d >= 0) & (d < l_gt),
                           p[jnp.clip(d, 0, l_gt - 1)], 0.0)
        term = jnp.dot(rows[s: s + nblk], band_s,
                       precision=jax.lax.Precision.HIGHEST)
        eq = term if eq is None else eq + term
    return eq.reshape(-1)[:t]


@functools.partial(jax.jit, static_argnames=("cfg", "n_anchors"))
def equalize_capture(cfg: PhyConfig, rx: jax.Array,
                     min_quality: float = 0.5, n_anchors: int = 4):
    """(rx_eq, info) — MMSE-equalized capture, or the input unchanged
    when no preamble trains above `min_quality`.  info carries
    (quality, lam, h) for diagnostics (`tm decode --equalize -v`).

    Training anchor selection is multi-candidate: the top `n_anchors`
    correlation peaks (non-max-suppressed by a preamble length) are
    each LS-fit and the one with the LOWEST fit residual wins.  The
    residual is a checkable proxy for the silent-lead-in assumption:
    a mid-burst preamble's "silence" region holds the previous frame's
    tail, the LS fit can't explain it, and lam blows up — so when any
    candidate DOES follow a real gap, it is chosen even if a mid-burst
    peak correlates more strongly (e.g. an attenuated first frame).

    The peel runs over per-128-lag-row (max, argmax) stats
    (sync.xcorr_row_stats) and suppression is
    row-granular: a row is consumed when ITS max lies within a
    preamble of a chosen anchor, so a secondary in-row peak can be
    shadowed by a stronger one < 128 lags away — anchors are
    residual-ranked training candidates, not decode decisions, and any
    shadowed preamble is an equally valid training window one peel
    slot later."""
    rx = jnp.asarray(rx, jnp.float32)
    pre = np.asarray(line_coding.preamble_waveform(cfg))
    l_pre = len(pre)
    # TM_EQ_ANCHOR_DEC=1 (trace-time): run the anchor search on a
    # stride-2 view — 1/4 the xcorr band FLOPs.  A decimated peak lands
    # within ~2 samples of the true one, well inside estimate_channel's
    # K0-tap acausal margin, and the decoder re-syncs on the equalized
    # output, so anchor phase never reaches a decode decision.  The
    # quality number shrinks (partial level overlap at odd phases), so
    # the min_quality gate sees ~0.6-0.8x its full-rate value — off
    # by default.
    dec = _os.environ.get("TM_EQ_ANCHOR_DEC", "0") == "1"
    if dec:
        rowmax, rowpos = sync_mod.xcorr_row_stats(rx[::2], pre[::2])
        rowpos = rowpos * 2             # back to full-rate positions
    else:
        rowmax, rowpos = sync_mod.xcorr_row_stats(rx, pre)
    sup = l_pre
    cands, quals = [], []
    rm = rowmax
    for _ in range(n_anchors):                      # static peel
        j = jnp.argmax(rm)
        a = rowpos[j].astype(jnp.int32)
        cands.append(a)
        quals.append(rm[j])
        rm = jnp.where(jnp.abs(rowpos - a) < sup, -jnp.inf, rm)
    anchors = jnp.stack(cands)
    quals = jnp.stack(quals)
    hs, lams = jax.vmap(lambda a: estimate_channel(cfg, rx, a))(anchors)
    lam_eff = jnp.where(quals >= min_quality, lams, jnp.inf)
    j = jnp.argmin(lam_eff)
    h, lam, anchor, quality = hs[j], lams[j], anchors[j], quals[j]
    g_t = _mmse_taps(h, lam)
    eq = _apply_fir(rx, g_t)
    use = quality >= min_quality
    out = jnp.where(use, eq, rx)
    return out, dict(quality=quality, lam=lam, h=h, applied=use,
                     anchor=anchor)


def decode_capture_eq(cfg: PhyConfig, samples, local_addr,
                      max_frames: int = 64):
    """Equalize, then decode on the fastest sound path.

    The equalizer is a pure FIR front-end, so it composes with
    :func:`trackmaker_tpu.phy.decoder.decode_capture_fast` — the
    speculative decoder (exact re-decode on overflow/nonconformance).
    Results equal the exact path up to slot compaction."""
    from trackmaker_tpu.phy.decoder import decode_capture_fast
    eq, _info = equalize_capture(cfg, jnp.asarray(samples, jnp.float32))
    return decode_capture_fast(cfg, eq, local_addr, max_frames=max_frames)


# ---------------------------------------------------------------------------
# Decision-directed refinement (captures with no clean leading preamble)


def refit_channel(cfg: PhyConfig, rx: np.ndarray, frames,
                  starts) -> tuple[np.ndarray, float]:
    """(h[N_CH], lam) — LS channel re-estimate trained on decoded
    frames instead of the preamble + silence model.

    Each decoded frame is re-encoded and only INTERIOR rows are kept:
    sample i of the window enters the system only when every regressor
    s[i + K0 - k] lies inside the known re-encoded waveform, so nothing
    is assumed about what surrounds the frame (silence, another frame's
    tail, a truncated capture edge — all fine).  This is what the
    preamble-trained fit cannot offer mid-burst, and with thousands of
    rows per frame the estimate is far better conditioned than the
    60-to-860-sample preamble window.  Host-side NumPy: frame lengths
    vary, the system is [~n_samples, 48] — milliseconds, not worth a
    retrace per shape."""
    from trackmaker_tpu.phy.encoder import PhyEncoder
    enc = PhyEncoder(cfg)
    a_rows, b_rows = [], []
    t = len(rx)
    for f, p in zip(frames, starts):
        s = np.asarray(enc.encode_frame(f), np.float64)
        n = len(s)
        i_lo = N_CH - 1 - K0            # j = i + K0 - k stays in [0, n)
        i_hi = min(n - 1 - K0, t - 1 - int(p))
        if i_hi - i_lo + 1 < 4 * N_CH:
            continue
        idx = np.arange(i_lo, i_hi + 1)
        a_rows.append(s[idx[:, None] + K0 - np.arange(N_CH)[None, :]])
        b_rows.append(np.asarray(rx, np.float64)[int(p) + idx])
    if not a_rows:
        raise ValueError("no frame long enough to train on")
    a = np.concatenate(a_rows)
    b = np.concatenate(b_rows)
    ata = a.T @ a + 1e-4 * np.eye(N_CH)
    h = np.linalg.solve(ata, a.T @ b)
    res = float(np.mean((a @ h - b) ** 2))
    sig = max(float(np.mean(b ** 2)), 1e-12)
    lam = float(np.clip(res / sig, 1e-4, 1.0))
    return h.astype(np.float32), lam


def _mmse_taps_np(h: np.ndarray, lam: float) -> np.ndarray:
    """NumPy mirror of `_mmse_taps` for host-refit taps."""
    hf = np.fft.rfft(h, n=N_FFT)
    g = np.conj(hf) / (np.abs(hf) ** 2 + lam)
    g_full = np.fft.irfft(g, n=N_FFT)
    lags = np.arange(-L_HALF, L_HALF + 1) % N_FFT
    return g_full[lags].astype(np.float32)


_apply_fir_jit = jax.jit(_apply_fir)


def _apply_taps_decode(cfg: PhyConfig, rx: jax.Array, g_t: jax.Array,
                       local_addr, max_frames: int):
    """Apply refit taps, then decode on the fastest sound path (the
    speculative decoder — it multiplies through every decision-directed
    iteration)."""
    from trackmaker_tpu.phy.decoder import decode_capture_fast
    return decode_capture_fast(cfg, _apply_fir_jit(rx, g_t), local_addr,
                               max_frames=max_frames)


def decode_capture_dd(cfg: PhyConfig, samples, local_addr,
                      max_frames: int = 8, max_iters: int = 3):
    """Decision-directed equalized decode.

    Bootstrap: the better of the preamble-trained equalized decode and
    the stock decode (mid-burst training can make the "equalized"
    capture WORSE than raw).  Then iterate: refit the channel on every
    decoded frame's interior (refit_channel — no silence assumption),
    re-equalize, re-decode; stop when the frame count stops improving.
    Returns the best DecodedFrames seen.  Each iteration reuses the
    same jitted apply+decode program (fixed shapes).

    Detection positions from either domain are valid refit anchors: the
    stock decoder's `start` is the direct-path arrival in raw rx, and
    the equalized decode's `start` is transmit-aligned by construction
    of pass 1 — both sit within the fit's K0-tap acausal margin."""
    from trackmaker_tpu.phy.decoder import decode_capture
    rx = np.asarray(samples, np.float32)
    rxj = jnp.asarray(rx)
    best = decode_capture_eq(cfg, rxj, local_addr, max_frames=max_frames)
    stock = decode_capture(cfg, rxj, local_addr, max_frames=max_frames)
    if int(np.asarray(stock.count)) > int(np.asarray(best.count)):
        best = stock
    for _ in range(max_iters):
        valid = np.asarray(best.valid)
        if not valid.any():
            break
        frames = best.to_frames()
        starts = np.asarray(best.start)[valid]
        try:
            h, lam = refit_channel(cfg, rx, frames, starts)
        except ValueError:
            break
        g_t = jnp.asarray(_mmse_taps_np(h, lam))
        res = _apply_taps_decode(cfg, rxj, g_t, local_addr, max_frames)
        if int(np.asarray(res.count)) <= int(np.asarray(best.count)):
            break
        best = res
    return best
