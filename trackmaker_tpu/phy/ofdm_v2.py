"""OFDM receiver v2: Schmidl-Cox fine timing, smoothed channel
estimation, per-symbol pilot-tone phase tracking.

The v1 receiver (phy/ofdm.py) is minimal: chirp correlation timing and
a one-tap equalizer from a SINGLE pilot symbol.  That single-symbol
channel estimate is as noisy as the data (an ~3 dB effective-SNR loss
near the cliff), timing rides entirely on the chirp peak, and nothing
tracks phase drift across a frame (sample-clock offset).  v2, designed
after review of v1 (design reference: the AFC/sync ideas in the
vendored fldigi modem, assets/psk.cxx):

* **Repeated-halves pilot symbol** — pilot energy only on EVEN bins, so
  its time body is two identical halves.  The Schmidl-Cox metric
  M(d) = P(d)^2 / R(d)^2 with P(d) = sum r[d+k] r[d+k+N/2] is computed
  on a +-search window around the chirp estimate and its argmax refines
  the symbol timing (robust to the chirp peak wandering in noise).
* **Smoothed channel estimate** — the acoustic channel's impulse
  response is shorter than the CP, so H(f) is smooth across bins: a
  complex moving average over the per-bin pilot estimates cuts the
  estimator noise by ~the window size, recovering the ~3 dB the noisy
  one-shot estimate costs v1.
* **Per-symbol pilot tones** — every `pilot_spacing`-th data bin
  carries a known BPSK pilot in EVERY data symbol.  Each symbol's
  common phase error (CPE) and linear phase-vs-bin slope (residual
  timing / sample-clock drift) are estimated from those tones and
  de-rotated before demapping, so +-tens-of-ppm clock offset no longer
  rotates late symbols off the constellation.

Frame format (modulate_bits_v2): chirp ‖ guard ‖ SC pilot symbol ‖ data
symbols (pilot tones embedded).  The v1 format stays untouched.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.dsp.osc import chirp_cached
from trackmaker_tpu.phy.ofdm import (
    OfdmConfig,
    _bits_to_qpsk,
    _qpsk_to_bits,
    _spectrum_to_time,
    _time_to_spectrum,
    _windows_spectrum,
    find_preambles,
)


@dataclasses.dataclass(frozen=True)
class OfdmV2Config(OfdmConfig):
    pilot_spacing: int = 8      # every Nth data bin is a pilot tone
    sc_search: int = 32         # +- timing search around the chirp peak
    smooth_bins: int = 9        # channel-estimate moving-average window
    track_cpe: bool = True      # per-symbol common-phase-error correction
    track_slope: bool = True    # per-symbol phase-slope (timing drift)
    use_sc: bool = True         # Schmidl-Cox fine timing

    @property
    def pilot_bin_idx(self) -> np.ndarray:
        return np.arange(0, self.n_bins, self.pilot_spacing)

    @property
    def data_bin_idx(self) -> np.ndarray:
        mask = np.ones(self.n_bins, bool)
        mask[self.pilot_bin_idx] = False
        return np.nonzero(mask)[0]

    @property
    def bits_per_symbol(self) -> int:  # type: ignore[override]
        return len(self.data_bin_idx) * self.bits_per_sym


@functools.lru_cache(maxsize=16)
def _sc_pilot(cfg: OfdmV2Config) -> np.ndarray:
    """BPSK pilot on even bins only -> repeated-halves time body."""
    rng = np.random.default_rng(cfg.pilot_seed)
    p = (2.0 * rng.integers(0, 2, cfg.n_bins) - 1.0).astype(np.complex64)
    even = ((np.arange(cfg.n_bins) + cfg.bin_lo) % 2 == 0)
    # doubled amplitude keeps the pilot symbol's power comparable
    return np.where(even, p * np.sqrt(2.0), 0.0).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _tone_pilots(cfg: OfdmV2Config) -> np.ndarray:
    rng = np.random.default_rng(cfg.pilot_seed + 1)
    n = len(cfg.pilot_bin_idx)
    return (2.0 * rng.integers(0, 2, n) - 1.0).astype(np.complex64)


@functools.partial(jax.jit, static_argnums=(0, 2))
def modulate_bits_v2(cfg: OfdmV2Config, bits: jax.Array,
                     n_bits: int) -> jax.Array:
    """uint8[B, n_bits] -> f32[B, frame_samples]."""
    b = bits.shape[0]
    n_sym = cfg.n_symbols(n_bits)
    pad = n_sym * cfg.bits_per_symbol - n_bits
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    qpsk = _bits_to_qpsk(bits).reshape(b, n_sym, len(cfg.data_bin_idx))
    subs = jnp.zeros((b, n_sym, cfg.n_bins), jnp.complex64)
    subs = subs.at[..., jnp.asarray(cfg.data_bin_idx)].set(qpsk)
    subs = subs.at[..., jnp.asarray(cfg.pilot_bin_idx)].set(
        jnp.asarray(_tone_pilots(cfg)))
    pilot = jnp.broadcast_to(
        jnp.asarray(_sc_pilot(cfg)), (b, 1, cfg.n_bins))
    t_syms = _spectrum_to_time(
        cfg, jnp.concatenate([pilot, subs], axis=1))
    body = t_syms.reshape(b, -1)
    pre = jnp.asarray(chirp_cached(
        cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz,
        cfg.sample_rate))
    pre = jnp.broadcast_to(pre, (b, cfg.preamble_len))
    guard = jnp.zeros((b, cfg.guard_samples), jnp.float32)
    return jnp.concatenate([pre, guard, body], axis=-1)


def _smooth_complex(h: jax.Array, win: int) -> jax.Array:
    """Complex moving average along the last axis (edge-clamped)."""
    n = h.shape[-1]
    pad = win // 2
    hp = jnp.concatenate(
        [jnp.repeat(h[..., :1], pad, -1), h,
         jnp.repeat(h[..., -1:], pad, -1)], axis=-1)
    k = jnp.ones(win) / win
    hi = jax.lax.Precision.HIGHEST
    re = (jnp.convolve(hp.real, k, mode="valid", precision=hi)
          if h.ndim == 1 else None)
    if re is not None:
        return (re + 1j * jnp.convolve(hp.imag, k, mode="valid",
                                       precision=hi))[:n]
    # batched: windowed sum via cumsum
    cs = jnp.cumsum(hp, axis=-1)
    cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)
    out = (cs[..., win:] - cs[..., :-win]) / win
    return out[..., :n]


def _sc_refine(cfg: OfdmV2Config, rx: jax.Array,
               starts: jax.Array) -> jax.Array:
    """Batched gather-free Schmidl-Cox fine timing: int[B] chirp-start
    estimates -> int[B] refined starts.

    Rather than a traced-start ``dynamic_slice`` plus a (2s, half)
    fancy-index window stack per frame (per-element gathers under the
    callers' vmap), this form fetches one 32-aligned segment per frame
    (512-lane row
    gathers + hierarchical 4x4 select, exact values) and computes
    P(d) / R(d) for all search lags as two banded-ones matmuls over
    the products — the same sums, as matmuls.  The 32-alignment
    residual `delta` only moves the search window WITHIN the computed
    lag range; masking to [delta, delta + 2s) keeps the argmax over
    exactly the positions a per-frame search would."""
    half = cfg.n_fft // 2
    s = cfg.sc_search
    body_off = cfg.preamble_len + cfg.guard_samples
    width = 2 * s + 32 + cfg.n_fft          # lag span + FFT half pair
    wpad = -(-width // 128) * 128           # 640 at the defaults
    nlag = 2 * s + 32                       # computed lags (96)
    t = rx.shape[-1]
    r_ = 512
    hi = t + body_off + cfg.cp_len + wpad + 2 * r_
    nrows = -(-hi // r_)
    rows = jnp.pad(rx.astype(jnp.float32),
                   (0, nrows * r_ - t)).reshape(nrows, r_)
    pilot_body = starts + body_off + cfg.cp_len
    base = jnp.maximum(pilot_body - s, 0)
    base32 = (base // 32) * 32
    delta = base - base32                   # in [0, 32)
    jb = base32 // r_
    c16 = (base32 % r_) // 32
    n_need = (wpad + r_ - 1) // r_ + 1
    src = rows[jb[:, None] + jnp.arange(n_need, dtype=jnp.int32)[None, :]]
    src = src.reshape(-1, n_need * r_)
    wide = src[:, :wpad + 96]
    for i in range(1, 4):
        wide = jnp.where((c16 // 4 == i)[:, None],
                         src[:, 128 * i: 128 * i + wpad + 96], wide)
    seg = wide[:, :wpad]
    for j in range(1, 4):
        seg = jnp.where((c16 % 4 == j)[:, None],
                        wide[:, 32 * j: 32 * j + wpad], seg)
    # P(d) = sum_k seg[d+k] seg[d+k+half], R(d) = sum_k seg[d+k+half]^2
    nprod = nlag + half - 1                 # max prod index + 1
    prod = seg[:, :nprod] * seg[:, half:half + nprod]
    sq = seg[:, half:half + nprod] ** 2
    jj = jax.lax.broadcasted_iota(jnp.int32, (nprod, nlag), 0)
    dd = jax.lax.broadcasted_iota(jnp.int32, (nprod, nlag), 1)
    band = ((jj >= dd) & (jj < dd + half)).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    p = jnp.dot(prod, band, precision=hi)   # (B, nlag)
    r2 = jnp.dot(sq, band, precision=hi)
    m = (p * p) / jnp.maximum(r2 * r2, 1e-12)
    lag = jnp.arange(nlag, dtype=jnp.int32)[None, :]
    ok = (lag >= delta[:, None]) & (lag < delta[:, None] + 2 * s)
    d_star = jnp.argmax(jnp.where(ok, m, -jnp.inf), axis=-1)
    return base32 + d_star - cfg.cp_len - body_off


@functools.partial(jax.jit, static_argnums=(0, 2))
def demodulate_at_v2(cfg: OfdmV2Config, rx: jax.Array, n_bits: int,
                     starts: jax.Array,
                     vsyms: jax.Array | None = None) -> jax.Array:
    """Demodulate v2 frames whose chirp starts at `starts` (int[B]) ->
    uint8[B, n_bits].

    `vsyms` (int[B], optional) marks how many leading data symbols of
    each frame are real — the pad-and-mask form for variable-length
    frames decoded at a fixed max size (OfdmStreamPhyV2): the CPE /
    phase-slope trajectory fits weight only symbols < vsym, so the
    noise-only tail cannot corrupt the per-frame linear fit.

    Windowing is gather-free end to end: `_sc_refine` for fine timing,
    then the
    shared `_windows_spectrum` aligned-row fetch — its 32-step CP
    back-off rides a per-frame-constant phase ramp into every bin,
    which the SC-pilot channel estimate absorbs exactly (pilot and
    data symbols share the same ramp; sym_len % 32 == 0)."""
    n_sym = cfg.n_symbols(n_bits)
    starts = jnp.asarray(starts, jnp.int32)
    pilots = jnp.asarray(_tone_pilots(cfg))
    pbins = jnp.asarray(cfg.pilot_bin_idx)
    dbins = jnp.asarray(cfg.data_bin_idx)
    sc_tx = jnp.asarray(_sc_pilot(cfg))

    fine = _sc_refine(cfg, rx, starts) if cfg.use_sc else starts
    all_spec = _windows_spectrum(cfg, rx, fine, n_sym)

    def one(spec, vsym):
        # --- smoothed channel estimate from the SC pilot (even bins)
        h_raw = spec[0] * jnp.conj(sc_tx) / jnp.maximum(
            jnp.abs(sc_tx) ** 2, 1e-12)
        even = ((jnp.arange(cfg.n_bins) + cfg.bin_lo) % 2 == 0)
        # interpolate odd bins from even neighbours, then smooth
        idx = jnp.arange(cfg.n_bins)
        left = jnp.clip(idx - 1, 0, cfg.n_bins - 1)
        right = jnp.clip(idx + 1, 0, cfg.n_bins - 1)
        h_f = jnp.where(even, h_raw,
                        0.5 * (h_raw[left] + h_raw[right]))
        h = _smooth_complex(h_f, cfg.smooth_bins)
        h = jnp.where(jnp.abs(h) < 1e-9, 1.0 + 0j, h)

        # --- one-tap equalize all data symbols
        eq = spec[1:] * jnp.conj(h) / jnp.maximum(jnp.abs(h) ** 2, 1e-12)

        # --- pilot-tone tracking: clock drift produces a phase
        # trajectory LINEAR in the symbol index, so fit one line per
        # frame instead of using raw per-symbol estimates — the fit
        # averages the estimator noise over all symbols (raw
        # per-symbol correction measurably costs ~1 dB at the AWGN
        # cliff) while capturing drift ramps exactly.
        # MRC-weight the pilot tones by |H|^2: the one-tap EQ divides
        # by H, so rolled-off bins' noise is amplified and an
        # unweighted sum lets them dominate the phase estimates on a
        # shaped channel (flat channels are unaffected).
        wmrc = jnp.abs(h[pbins]) ** 2
        pt = eq[:, pbins] * jnp.conj(pilots) * wmrc   # (n_sym, n_pilot)
        cpe = jnp.sum(pt, axis=-1)
        srange = jnp.arange(n_sym, dtype=jnp.float32)
        w = (srange < vsym).astype(jnp.float32)       # valid-symbol mask
        nw = jnp.maximum(jnp.sum(w), 1.0)
        if cfg.track_cpe and n_sym > 1:
            # per-symbol increment from consecutive ratios (no unwrap);
            # only pairs fully inside the valid prefix contribute
            wp = w[1:]
            binc = jnp.angle(jnp.sum(wp * cpe[1:] * jnp.conj(cpe[:-1])))
            a0 = jnp.angle(jnp.sum(w * cpe * jnp.exp(-1j * binc * srange)))
            theta = a0 + binc * srange
        elif cfg.track_cpe:
            theta = jnp.angle(cpe)
        else:
            theta = jnp.zeros(n_sym)
        npil = pt.shape[-1]
        lo = jnp.sum(pt[:, : npil // 2], axis=-1)
        hi = jnp.sum(pt[:, npil - npil // 2:], axis=-1)
        dphi = jnp.angle(hi * jnp.conj(lo))           # over ~half the band
        span = (pbins[npil - npil // 2:].mean()
                - pbins[: npil // 2].mean())
        slope_raw = dphi / jnp.maximum(span, 1.0)
        if cfg.track_slope and n_sym > 1:
            # weighted least-squares line over the valid symbols
            sm = jnp.sum(w * srange) / nw
            den = jnp.sum(w * (srange - sm) ** 2)
            d1 = (jnp.sum(w * (srange - sm) * slope_raw)
                  / jnp.maximum(den, 1.0))
            c0 = jnp.sum(w * slope_raw) / nw - d1 * sm
            slope = c0 + d1 * srange
        elif cfg.track_slope:
            slope = slope_raw
        else:
            slope = jnp.zeros(n_sym)
        binr = jnp.arange(cfg.n_bins, dtype=jnp.float32)
        rot = jnp.exp(-1j * (theta[:, None]
                             + slope[:, None]
                             * (binr[None, :] - jnp.mean(binr))))
        eqc = eq * rot

        bits = _qpsk_to_bits(eqc[:, dbins].reshape(-1))
        return bits[:n_bits]

    vs = (jnp.full(starts.shape, n_sym, jnp.int32) if vsyms is None
          else jnp.asarray(vsyms, jnp.int32))
    return jax.vmap(one)(all_spec, vs)


class OfdmStreamPhyV2:
    """Variable-length v2 OFDM PHY with the line-coded PHY's duck type
    (``encode_frames`` / ``process_samples`` / ``reset``) — the MAC
    (CSMA/ARQ/GBN) and everything above it run unchanged over the v2
    receiver, like :class:`trackmaker_tpu.phy.ofdm.OfdmStreamPhy` does
    for v1.

    Length handling is two fixed-shape passes per detection: a
    header-only pass (1 data symbol >= the 56-bit frame header) parses
    the length, then the full pass demodulates at the max frame size
    with `vsyms` masking the pilot-trajectory fits to the real symbols
    (pad-and-mask; no per-length recompilation)."""

    def __init__(self, cfg: OfdmV2Config = OfdmV2Config(),
                 max_frame_bytes: int = 263,
                 local_addr: int | None = None):
        assert cfg.bits_per_symbol >= 56, \
            "first data symbol must cover the frame header"
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.max_syms = cfg.n_symbols(max_frame_bytes * 8)
        self._buf = np.zeros(0, np.float32)
        self.preamble_len = cfg.preamble_len

    # -- encoder side --------------------------------------------------

    def encode_frame(self, frame: Frame) -> np.ndarray:
        from trackmaker_tpu.core import bitops
        bits = bitops.bytes_to_bits_host(frame.to_bytes())
        w = modulate_bits_v2(self.cfg, jnp.asarray(bits[None]),
                             bits.shape[-1])
        return np.asarray(w[0])

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        parts = []
        for i, f in enumerate(frames):
            parts.append(self.encode_frame(f))
            if i < len(frames) - 1:
                parts.append(np.zeros(gap_samples, np.float32))
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    # -- streaming decoder side -----------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def frame_samples(self, n_payload: int) -> int:
        return self.cfg.frame_samples((7 + n_payload) * 8)

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        cfg = self.cfg
        if len(self._buf) < cfg.preamble_len + 1:
            return []
        out: list[Frame] = []
        consumed = 0
        bucket = 4096
        while bucket < len(self._buf):
            bucket *= 2
        padded = np.zeros(bucket, np.float32)
        padded[: len(self._buf)] = self._buf
        pj = jnp.asarray(padded)
        starts = np.asarray(find_preambles(cfg, pj, 16))
        for s in starts[starts >= 0]:
            s = int(s)
            if s < consumed:
                continue
            min_end = s + cfg.frame_samples(1)  # header needs 1st symbol
            if min_end > len(self._buf):
                break  # frame still arriving
            hdr_bits = np.asarray(demodulate_at_v2(
                cfg, pj, 56, jnp.asarray([s])))[0]
            hdr = np.packbits(hdr_bits[:56])
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - 7:
                consumed = s + cfg.preamble_len
                continue
            total_bits = (7 + data_len) * 8
            frame_end = s + cfg.frame_samples(total_bits)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            bits = np.asarray(demodulate_at_v2(
                cfg, pj, self.max_syms * cfg.bits_per_symbol,
                jnp.asarray([s]),
                jnp.asarray([cfg.n_symbols(total_bits)])))[0]
            f = Frame.from_bits(bits[:total_bits])
            consumed = frame_end
            if f is None:
                continue
            if self.local_addr is not None and f.dst != self.local_addr:
                continue
            out.append(f)
        if consumed:
            keep = max(consumed - (cfg.preamble_len - 1), 0)
            self._buf = self._buf[keep:]
        elif len(self._buf) > 10 * cfg.sample_rate:
            self._buf = self._buf[-cfg.preamble_len:]
        return out


class OfdmModemV2:
    """Frame-level facade over the v2 waveform (equal-length frames)."""

    def __init__(self, cfg: OfdmV2Config = OfdmV2Config()):
        self.cfg = cfg

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        from trackmaker_tpu.core import bitops
        assert frames
        nb = {len(f.to_bytes()) * 8 for f in frames}
        assert len(nb) == 1, "group equal-length frames"
        bits = jnp.asarray(np.stack(
            [bitops.bytes_to_bits_host(f.to_bytes()) for f in frames]))
        waves = np.asarray(modulate_bits_v2(self.cfg, bits, nb.pop()))
        parts = []
        for i, w in enumerate(waves):
            parts.append(w)
            if i < len(waves) - 1:
                parts.append(np.zeros(gap_samples, np.float32))
        return np.concatenate(parts)

    def decode(self, rx: np.ndarray, frame_bytes_len: int,
               max_frames: int = 64) -> list[Frame]:
        n_bits = frame_bytes_len * 8
        starts = np.asarray(find_preambles(
            self.cfg, jnp.asarray(rx), max_frames))
        starts = starts[starts >= 0]
        if len(starts) == 0:
            return []
        bits = np.asarray(demodulate_at_v2(
            self.cfg, jnp.asarray(rx), n_bits, jnp.asarray(starts)))
        out = []
        for row in bits:
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
