"""Sample-clock offset recovery.

Cheap sound cards disagree by 10s-to-1000s of ppm; the line-coded PHY
tolerates only ~100 ppm over a max-size frame (no in-frame timing
tracking — same as the reference).  Two batched strategies:

* :func:`decode_with_clock_search` — resample the capture at a grid of
  candidate ratios (one batched resample + one vmapped decode) and keep
  the ratio that yields the most CRC-valid frames.  Robust, brute-force,
  embarrassingly parallel: exactly the kind of search a batch device makes free.
* :func:`estimate_clock_ppm` — closed-form estimate from detected
  preamble spacing vs the nominal frame pitch, for telemetry or to
  center a narrow search grid.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.dsp.channel import clock_offset
from trackmaker_tpu.phy.decoder import DecodedFrames, decode_capture


def decode_with_clock_search(
    cfg: PhyConfig,
    samples,                       # f32[T]
    local_addr: int,
    ppm_grid=(-2000.0, -1000.0, -500.0, 0.0, 500.0, 1000.0, 2000.0),
    max_frames: int = 64,
) -> tuple[DecodedFrames, float]:
    """-> (best decode, chosen_ppm).  Resampling by -ppm undoes a +ppm
    transmitter-fast clock."""
    x = jnp.asarray(samples, jnp.float32)
    grid = jnp.asarray(ppm_grid, jnp.float32)

    @jax.jit
    def run(xx):
        def one(ppm):
            y = clock_offset(xx, -ppm)
            return decode_capture(cfg, y, local_addr,
                                  max_frames=max_frames)
        return jax.vmap(one)(grid)

    res = run(x)
    counts = np.asarray(res.count)
    best = int(np.argmax(counts))
    pick = jax.tree_util.tree_map(lambda a: a[best], res)
    return pick, float(ppm_grid[best])


def estimate_frame_ppm(cfg: PhyConfig, window, n_levels: int,
                       max_shift: int = 8, segments: int = 8):
    """Per-frame early-late timing estimate from one frame window.

    `window` is f32[W] starting at the frame body (preamble stripped),
    laid out as `n_levels` nominal levels of `samples_per_level` (spb).
    For a level boundary j and shift s, the transition metric
    |mean(level j-1 at s) - mean(level j at s)| peaks where s matches
    the local timing offset — but the level grating makes the metric
    PERIODIC in spb (shifting a whole level lands on another boundary),
    so the offset is only observable modulo spb.  The estimator
    therefore works in phase space: metrics are summed over `segments`
    equal spans, collapsed modulo spb, and each segment's offset phase
    is the circular centroid of the 3-point residue curve; the phases
    unwrap along the frame (per-segment drift is far below half a
    level for any sane ppm) into a trajectory whose weighted
    least-squares slope is the drift in samples/level — i.e. the ppm
    (sync refinement pins the frame start, so the trajectory starts
    near phase 0).

    Returns (ppm_estimate, weight) — callers gate on the weight to
    reject windows without line-coded content."""
    spb = cfg.samples_per_level
    x = jnp.asarray(window, jnp.float32)
    shifts = jnp.arange(-max_shift, max_shift + 1)
    n_s = 2 * max_shift + 1
    # level means at shift s are a shifted contiguous view reshaped to
    # (n_levels, spb) — no gathers
    xp = jnp.pad(x, (max_shift, max_shift + spb))

    def metric_at(s):
        xs = jax.lax.dynamic_slice(xp, (s + max_shift,),
                                   (n_levels * spb,))
        lm = jnp.mean(xs.reshape(n_levels, spb), axis=-1)
        return jnp.abs(lm[:-1] - lm[1:])              # boundaries 1..n-1

    m = jax.vmap(metric_at)(shifts)                   # (S, n_levels-1)
    per_seg = -(-(n_levels - 1) // segments)
    pad = per_seg * segments - (n_levels - 1)
    mseg = jnp.pad(m, ((0, 0), (0, pad))).reshape(
        n_s, segments, per_seg).sum(-1)               # (S, segments)

    # collapse modulo spb: mean metric per residue class
    res = jnp.mod(shifts, spb)                        # (S,)
    onehot = (res[:, None] == jnp.arange(spb)[None, :]).astype(
        jnp.float32)                                  # (S, spb)
    cnt = jnp.maximum(jnp.sum(onehot, axis=0), 1.0)
    mp = jnp.dot(mseg.T, onehot, precision=jax.lax.Precision.HIGHEST) \
        / cnt[None, :]                                # (segments, spb)
    # circular centroid -> offset phase in samples, (-spb/2, spb/2]
    ang = 2.0 * jnp.pi * jnp.arange(spb) / spb
    z = jnp.sum(mp * jnp.exp(1j * ang)[None, :], axis=-1)
    phase = jnp.angle(z) * spb / (2.0 * jnp.pi)       # (segments,)
    w = jnp.abs(z)                                    # peakedness

    # unwrap along the frame, anchored near 0 at the start
    d = phase[1:] - phase[:-1]
    d = d - spb * jnp.round(d / spb)
    traj = jnp.concatenate([phase[:1], phase[0] + jnp.cumsum(d)])
    traj = traj - spb * jnp.round(traj[0] / spb)

    centers = (jnp.arange(segments, dtype=jnp.float32) + 0.5) * per_seg
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    cm = jnp.sum(w * centers) / wsum
    den = jnp.maximum(jnp.sum(w * (centers - cm) ** 2), 1e-9)
    slope = jnp.sum(w * (centers - cm) * traj) / den  # samples/level
    return slope / spb * 1e6, jnp.sum(w)


def decode_with_timing_gate(
    cfg: PhyConfig,
    samples,                       # f32[T]
    local_addr: int,
    max_frames: int = 64,
    max_retry: int = 16,
    max_shift: int = 8,
) -> tuple[DecodedFrames, DecodedFrames]:
    """Exact decode + per-frame early-late retry of failed candidates.

    Beyond-parity robustness mode (the reference has no in-frame timing
    tracking): frames from transmitters with *different* clock skews in
    ONE capture defeat the whole-capture resample search
    (:func:`decode_with_clock_search` picks a single global ratio);
    here every correlation hit the exact decoder could not turn into a
    valid frame gets its own drift estimate and a per-candidate
    resampled re-decode, vmapped.

    Returns ``(exact, recovered)``: the untouched exact decode plus the
    per-candidate recoveries (positions in `recovered.start` are
    absolute).  Caveat (documented, CRC-gated): a retried candidate
    inside a *failed* region re-decodes independently, without the
    sequential consumption walk suppressing embedded-preamble hits."""
    from trackmaker_tpu.phy import line_coding
    from trackmaker_tpu.phy.decoder import decode_capture_fast
    from trackmaker_tpu.phy.spec_decode import _extract_candidates
    from trackmaker_tpu.sync import normalized_xcorr
    from trackmaker_tpu.sync.correlate import preamble_energy

    x = jnp.asarray(samples, jnp.float32)
    res = decode_capture_fast(cfg, x, local_addr, max_frames=max_frames)

    pre_np = line_coding.preamble_waveform(cfg)
    corr = normalized_xcorr(x, pre_np, preamble_energy(pre_np))
    hits = np.array(corr >= cfg.correlation_threshold)
    # drop hits covered by a valid frame's extent
    valid = np.asarray(res.valid)
    starts = np.asarray(res.start)[valid]
    lens = np.asarray(res.length)[valid]
    covered = np.zeros(hits.shape[-1], bool)
    for s, ln in zip(starts, lens):
        ext = cfg.preamble_len + cfg.samples_for_bits(
            (7 + int(ln)) * 8)
        covered[max(s, 0): s + ext] = True
    hits &= ~covered
    cand, n_valid, _overflow = _extract_candidates(
        jnp.asarray(hits), max_retry)
    cand_h = np.asarray(cand)
    nv = int(np.asarray(n_valid))

    max_window = cfg.samples_for_bits((7 + cfg.max_frame_bytes) * 8)
    wlen = cfg.preamble_len + max_window + 4 * max_shift + 16
    xp = jnp.concatenate([x, jnp.zeros(wlen + 8, jnp.float32)])
    n_levels = max_window // cfg.samples_per_level

    def retry(c):
        win = jax.lax.dynamic_slice(xp, (jnp.clip(c, 0),), (wlen,))
        body = win[cfg.preamble_len:]
        ppm, _w = estimate_frame_ppm(cfg, body, n_levels,
                                     max_shift=max_shift)
        fixed = clock_offset(win, ppm)        # undo the drift
        return decode_capture(cfg, fixed, local_addr, max_frames=1), ppm

    rec, ppms = jax.jit(jax.vmap(retry))(jnp.clip(cand, 0))
    slot_ok = (jnp.arange(max_retry) < nv)
    ok = rec.valid[:, 0] & slot_ok & (rec.start[:, 0]
                                      <= 2 * max_shift)
    recovered = jax.tree_util.tree_map(lambda a: a[:, 0], rec)
    abs_start = np.where(np.asarray(ok),
                         cand_h + np.asarray(recovered.start), -1)
    # dedupe: nearby hits (within the sync margin) recover the same
    # frame; keep the first
    okh = np.asarray(ok).copy()
    seen: list[int] = []
    for i in range(len(okh)):
        if not okh[i]:
            continue
        if any(abs(int(abs_start[i]) - p) <= 2 * cfg.sync_margin
               for p in seen):
            okh[i] = False
        else:
            seen.append(int(abs_start[i]))
    recovered = recovered._replace(
        valid=jnp.asarray(okh),
        start=jnp.asarray(np.where(okh, abs_start, -1)))
    return res, recovered


def estimate_clock_ppm(starts: np.ndarray, nominal_pitch: float) -> float:
    """Estimate ppm from detected preamble start positions of a regular
    frame train: observed pitch / nominal - 1, in ppm."""
    starts = np.asarray(starts, np.float64)
    starts = starts[starts >= 0]
    if len(starts) < 2:
        return 0.0
    observed = np.median(np.diff(starts))
    return (observed / nominal_pitch - 1.0) * 1e6
