"""Adaptive per-bin bit-loading on the OFDM v2 waveform.

The acoustic channel is strongly frequency-selective (speaker/mic
roll-off, room modes): a uniform constellation wastes the good bins and
drowns the bad ones.  Classic DMT bit-loading (the scheme ADSL uses)
fixes this: probe the channel once, estimate per-bin SNR, and give each
data bin the largest constellation its SNR supports — 16-QAM on strong
bins, QPSK/BPSK on middling ones, nothing on dead ones.

This is a beyond-parity extension: the reference stack is single
-carrier and its vendored study material (assets/psk.cxx) is
fixed-constellation.  Batched shape: the loading is a *static* tuple
on a frozen config, so every mod/demod specializes at trace time into
three dense per-class gathers (BPSK/QPSK/16-QAM bins) — no per-bin
control flow, one IFFT/FFT batch over all symbols, same as the v1/v2
paths.

Pipeline:

* ``probe_waveform`` / ``estimate_bin_snr`` — a probe frame (chirp ‖ SC
  pilot ‖ K known uniform-QPSK symbols); the receiver equalizes with
  the v2 smoothed channel estimate and measures per-bin error power ->
  SNR.
* ``choose_loading`` — SNR-gap thresholds -> bits/bin in {0,1,2,4,6}.
* ``OfdmAdaptiveModem`` — encode/decode with a chosen loading; the
  per-symbol pilot tones and trajectory tracking come from the v2
  receiver design.
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
    _bits_to_qpsk,
    _qpsk_to_bits,
    _spectrum_to_time,
    _time_to_spectrum,
    find_preambles,
)
from trackmaker_tpu.phy.ofdm_v2 import (
    OfdmV2Config,
    _sc_pilot,
    _smooth_complex,
    _tone_pilots,
)


@dataclasses.dataclass(frozen=True)
class OfdmAdaptiveConfig(OfdmV2Config):
    # bits per data bin (aligned with data_bin_idx), in {0, 1, 2, 4, 6};
    # default: uniform QPSK (equivalent to v2)
    loading: tuple = ()
    # per-data-bin amplitude gains (water-filling, choose_gains);
    # default: unit power everywhere.  Values must be quantize_gain()
    # outputs so both ends agree bit-exactly over the handshake.
    gains: tuple = ()
    probe_symbols: int = 8
    probe_seed: int = 99

    def resolved_loading(self) -> np.ndarray:
        n = len(self.data_bin_idx)
        if not self.loading:
            return np.full(n, 2, np.int32)
        assert len(self.loading) == n, (len(self.loading), n)
        lv = np.asarray(self.loading, np.int32)
        assert set(np.unique(lv)).issubset({0, 1, 2, 4, 6})
        return lv

    def resolved_gains(self) -> np.ndarray:
        n = len(self.data_bin_idx)
        if not self.gains:
            return np.ones(n, np.float32)
        assert len(self.gains) == n, (len(self.gains), n)
        return np.asarray(self.gains, np.float32)

    @property
    def bits_per_symbol(self) -> int:  # type: ignore[override]
        return int(self.resolved_loading().sum())


# Gray-coded 16-QAM: 2 bits -> amplitude level (00,01,11,10 -> -3,-1,1,3)
_QAM16_LEVELS = np.asarray([-3.0, -1.0, 1.0, 3.0], np.float32)
_GRAY2 = np.asarray([0, 1, 3, 2], np.int32)        # bits -> level index
_QAM16_SCALE = 1.0 / np.sqrt(10.0)
# Gray-coded 64-QAM: 3 bits per axis.  Level index l (amplitude
# (2l-7)/sqrt(42)) carries Gray code l^(l>>1); _GRAY3 is the INVERSE
# (bit triple -> level index), so adjacent amplitudes differ in one bit.
_QAM64_LEVELS = np.asarray([-7., -5., -3., -1., 1., 3., 5., 7.],
                           np.float32)
_GRAY3 = np.asarray([0, 1, 3, 2, 7, 6, 4, 5], np.int32)
_GRAY3_ENC = np.asarray([l ^ (l >> 1) for l in range(8)], np.int32)
_QAM64_SCALE = 1.0 / np.sqrt(42.0)


@functools.lru_cache(maxsize=16)
def _class_idx(cfg: OfdmAdaptiveConfig):
    """Static per-class bin indices and the bit layout.

    Per-symbol bit order: [all BPSK bins' bits ‖ all QPSK bins' bit
    pairs ‖ all 16-QAM bins' quads ‖ all 64-QAM bins' six-tuples], each
    class in ascending bin order — a fixed permutation both ends derive
    from the shared loading.
    Returns (per-class bins, per-class gains), gains in class order."""
    # NOTE: data_bin_idx / pilot_bin_idx are bin-RELATIVE (0..n_bins),
    # matching ofdm_v2's convention
    lv = cfg.resolved_loading()
    g = cfg.resolved_gains()
    dbins = cfg.data_bin_idx
    b1 = dbins[lv == 1]
    b2 = dbins[lv == 2]
    b4 = dbins[lv == 4]
    b6 = dbins[lv == 6]
    return ((tuple(b1.tolist()), tuple(b2.tolist()),
             tuple(b4.tolist()), tuple(b6.tolist())),
            (tuple(g[lv == 1].tolist()), tuple(g[lv == 2].tolist()),
             tuple(g[lv == 4].tolist()), tuple(g[lv == 6].tolist())))


def _bits_to_qam16(bits: jax.Array) -> jax.Array:
    """uint8[..., 4k] -> complex64[..., k]."""
    quads = bits.reshape(*bits.shape[:-1], -1, 4).astype(jnp.int32)
    gi = jnp.asarray(_GRAY2)[quads[..., 0] * 2 + quads[..., 1]]
    gq = jnp.asarray(_GRAY2)[quads[..., 2] * 2 + quads[..., 3]]
    lv = jnp.asarray(_QAM16_LEVELS)
    return (lv[gi] + 1j * lv[gq]) * _QAM16_SCALE


def _qam16_to_bits(sym: jax.Array) -> jax.Array:
    """Hard decision, inverse of _bits_to_qam16."""
    def axis_bits(v):
        lvl = jnp.clip(jnp.round((v / _QAM16_SCALE + 3.0) / 2.0),
                       0, 3).astype(jnp.int32)
        # level index -> Gray bit pair: inverse of _GRAY2
        inv = jnp.asarray([0, 1, 3, 2], jnp.int32)  # self-inverse
        g = inv[lvl]
        return jnp.stack([g // 2, g % 2], axis=-1)
    bi = axis_bits(sym.real)
    bq = axis_bits(sym.imag)
    out = jnp.concatenate([bi, bq], axis=-1)
    return out.reshape(*sym.shape[:-1], -1).astype(jnp.uint8)


def _bits_to_qam64(bits: jax.Array) -> jax.Array:
    """uint8[..., 6k] -> complex64[..., k] (I bits first, MSB first)."""
    six = bits.reshape(*bits.shape[:-1], -1, 6).astype(jnp.int32)
    vi = six[..., 0] * 4 + six[..., 1] * 2 + six[..., 2]
    vq = six[..., 3] * 4 + six[..., 4] * 2 + six[..., 5]
    lv = jnp.asarray(_QAM64_LEVELS)
    gi = jnp.asarray(_GRAY3)[vi]
    gq = jnp.asarray(_GRAY3)[vq]
    return (lv[gi] + 1j * lv[gq]) * _QAM64_SCALE


def _qam64_to_bits(sym: jax.Array) -> jax.Array:
    """Hard decision, inverse of _bits_to_qam64."""
    def axis_bits(v):
        lvl = jnp.clip(jnp.round((v / _QAM64_SCALE + 7.0) / 2.0),
                       0, 7).astype(jnp.int32)
        g = jnp.asarray(_GRAY3_ENC)[lvl]      # level -> Gray bit triple
        return jnp.stack([g >> 2 & 1, g >> 1 & 1, g & 1], axis=-1)
    bi = axis_bits(sym.real)
    bq = axis_bits(sym.imag)
    out = jnp.concatenate([bi, bq], axis=-1)
    return out.reshape(*sym.shape[:-1], -1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(0, 2))
def modulate_bits_adaptive(cfg: OfdmAdaptiveConfig, bits: jax.Array,
                           n_bits: int) -> jax.Array:
    """uint8[B, n_bits] -> f32[B, frame_samples] with per-bin loading
    and water-filling amplitude gains."""
    (b1, b2, b4, b6), (g1, g2, g4, g6) = _class_idx(cfg)
    n1, n2, n4, n6 = len(b1), len(b2), len(b4), len(b6)
    bps = cfg.bits_per_symbol
    b = bits.shape[0]
    n_sym = -(-n_bits // bps)
    pad = n_sym * bps - n_bits
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    sym_bits = bits.reshape(b, n_sym, bps)

    subs = jnp.zeros((b, n_sym, cfg.n_bins), jnp.complex64)
    off = 0
    if n1:
        s1 = (2.0 * sym_bits[..., :n1].astype(jnp.float32) - 1.0
              ).astype(jnp.complex64)
        subs = subs.at[..., jnp.asarray(b1)].set(
            s1 * jnp.asarray(g1, jnp.complex64))
        off += n1
    if n2:
        s2 = _bits_to_qpsk(sym_bits[..., off:off + 2 * n2])
        subs = subs.at[..., jnp.asarray(b2)].set(
            s2 * jnp.asarray(g2, jnp.complex64))
        off += 2 * n2
    if n4:
        s4 = _bits_to_qam16(sym_bits[..., off:off + 4 * n4])
        subs = subs.at[..., jnp.asarray(b4)].set(
            s4 * jnp.asarray(g4, jnp.complex64))
        off += 4 * n4
    if n6:
        s6 = _bits_to_qam64(sym_bits[..., off:off + 6 * n6])
        subs = subs.at[..., jnp.asarray(b6)].set(
            s6 * jnp.asarray(g6, jnp.complex64))
    subs = subs.at[..., jnp.asarray(cfg.pilot_bin_idx)].set(
        jnp.asarray(_tone_pilots(cfg)))

    pilot = jnp.broadcast_to(jnp.asarray(_sc_pilot(cfg)),
                             (b, 1, cfg.n_bins))
    t_syms = _spectrum_to_time(cfg, jnp.concatenate([pilot, subs], axis=1))
    body = t_syms.reshape(b, -1)
    pre = jnp.asarray(chirp_cached(
        cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz,
        cfg.sample_rate))
    pre = jnp.broadcast_to(pre, (b, cfg.preamble_len))
    guard = jnp.zeros((b, cfg.guard_samples), jnp.float32)
    return jnp.concatenate([pre, guard, body], axis=-1)


def _equalized_symbols(cfg, rx_pad, start, n_sym):
    """Shared receiver front half: refined timing is inherited from the
    chirp (probe/data frames are short; the v2 SC search is skipped
    here for simplicity), smoothed SC channel estimate, one-tap EQ."""
    total = (1 + n_sym) * cfg.sym_len
    body_off = cfg.preamble_len + cfg.guard_samples
    seg = jax.lax.dynamic_slice(
        rx_pad, (jnp.maximum(start, 0) + body_off,), (total,))
    spec = _time_to_spectrum(cfg, seg.reshape(1 + n_sym, cfg.sym_len))
    sc_tx = jnp.asarray(_sc_pilot(cfg))
    h_raw = spec[0] * jnp.conj(sc_tx) / jnp.maximum(
        jnp.abs(sc_tx) ** 2, 1e-12)
    even = ((jnp.arange(cfg.n_bins) + cfg.bin_lo) % 2 == 0)
    idx = jnp.arange(cfg.n_bins)
    left = jnp.clip(idx - 1, 0, cfg.n_bins - 1)
    right = jnp.clip(idx + 1, 0, cfg.n_bins - 1)
    h_f = jnp.where(even, h_raw, 0.5 * (h_raw[left] + h_raw[right]))
    h = _smooth_complex(h_f, cfg.smooth_bins)
    h = jnp.where(jnp.abs(h) < 1e-9, 1.0 + 0j, h)
    eq = spec[1:] * jnp.conj(h) / jnp.maximum(jnp.abs(h) ** 2, 1e-12)

    # per-symbol pilot-tone CPE correction (v2's tracking, CPE only —
    # adaptive frames are equal-length and short).  MRC-weight the
    # pilot tones by |H|^2: the one-tap EQ divides by H, so dead bins'
    # noise is enormously amplified and an unweighted sum lets them
    # dominate the phase estimate (measured ~6 deg residual rotations
    # on a shaped channel vs ~1 deg weighted).
    pbins = jnp.asarray(cfg.pilot_bin_idx)
    wmrc = jnp.abs(h[pbins]) ** 2
    pt = eq[:, pbins] * jnp.conj(jnp.asarray(_tone_pilots(cfg)))
    cpe = jnp.sum(pt * wmrc, axis=-1)
    theta = jnp.angle(jnp.where(jnp.abs(cpe) < 1e-12, 1.0 + 0j, cpe))
    return eq * jnp.exp(-1j * theta)[:, None], h


@functools.partial(jax.jit, static_argnums=(0, 2))
def soft_demodulate_at_adaptive(cfg: OfdmAdaptiveConfig, rx: jax.Array,
                                n_bits: int, starts: jax.Array
                                ) -> jax.Array:
    """Per-bit soft decisions (max-log, positive = "bit is 1") for the
    Viterbi decoder — f32[B, n_bits], same bit layout as
    :func:`demodulate_at_adaptive`.

    BPSK: re(s).  QPSK (Gray, b0 = im<0, b1 = re<0): (-im, -re).
    Gray 16-QAM per axis (00,01,11,10 -> -3,-1,1,3 levels): the sign
    bit's LLR is the axis value, the inner/outer bit's is
    (2/sqrt(10) - |v|) — the max-log distance difference up to a
    constant factor.

    Every bin's values are weighted by (|H| g)^2: the one-tap EQ
    divides by H and the gain normalization divides by the bin's
    water-filling amplitude g, so post-EQ noise variance is
    sigma^2/(|H| g)^2 per bin and the true LLR carries an (|H| g)^2
    factor.  Without the |H|^2 part a -10 dB roll-off bin votes as
    loudly as a clean one and single Viterbi error events corrupt the
    block start (measured: shifted length fields on the shaped-channel
    corpus).  Monotone COMMON scalings don't change Viterbi decisions;
    per-bin RELATIVE weights do.
    """
    (b1, b2, b4, b6), (g1, g2, g4, g6) = _class_idx(cfg)
    bps = cfg.bits_per_symbol
    n_sym = -(-n_bits // bps)
    pad_n = (1 + n_sym) * cfg.sym_len + cfg.preamble_len \
        + cfg.guard_samples + cfg.n_fft + 8
    rx_pad = jnp.concatenate(
        [rx.astype(jnp.float32), jnp.zeros(pad_n, jnp.float32)])
    thr = 2.0 * _QAM16_SCALE
    s64 = _QAM64_SCALE

    def one(start):
        eqc, h = _equalized_symbols(cfg, rx_pad, start, n_sym)
        w = jnp.abs(h) ** 2
        w = w / jnp.maximum(jnp.max(w), 1e-12)        # common scale only
        parts = []
        if b1:
            ga = jnp.asarray(g1)
            s1 = eqc[:, jnp.asarray(b1)] / ga
            parts.append((s1.real
                          * (w[jnp.asarray(b1)] * ga ** 2))[..., None])
        if b2:
            ga = jnp.asarray(g2)
            s2 = eqc[:, jnp.asarray(b2)] / ga
            parts.append(jnp.stack([-s2.imag, -s2.real], axis=-1)
                         * (w[jnp.asarray(b2)] * ga ** 2)[None, :, None])
        if b4:
            ga = jnp.asarray(g4)
            s4 = eqc[:, jnp.asarray(b4)] / ga
            parts.append(jnp.stack(
                [s4.real, thr - jnp.abs(s4.real),
                 s4.imag, thr - jnp.abs(s4.imag)], axis=-1)
                * (w[jnp.asarray(b4)] * ga ** 2)[None, :, None])
        if b6:
            # max-log LLRs for Gray 8-PAM per axis (v = equalized amp):
            # sign bit = v; middle bit = 4s - |v|; inner bit =
            # 2s - ||v| - 4s|  (s = 1/sqrt(42))
            ga = jnp.asarray(g6)
            s6 = eqc[:, jnp.asarray(b6)] / ga

            def pam8(v):
                return [v, 4 * s64 - jnp.abs(v),
                        2 * s64 - jnp.abs(jnp.abs(v) - 4 * s64)]
            parts.append(jnp.stack(pam8(s6.real) + pam8(s6.imag),
                                   axis=-1)
                         * (w[jnp.asarray(b6)] * ga ** 2)[None, :, None])
        soft = jnp.concatenate(
            [p.reshape(p.shape[0], -1) for p in parts], axis=-1)
        return soft.reshape(-1)[:n_bits]

    return jax.vmap(one)(jnp.asarray(starts, jnp.int32))


@functools.partial(jax.jit, static_argnums=(0, 2))
def demodulate_at_adaptive(cfg: OfdmAdaptiveConfig, rx: jax.Array,
                           n_bits: int, starts: jax.Array) -> jax.Array:
    """Demodulate loaded frames at `starts` -> uint8[B, n_bits]."""
    (b1, b2, b4, b6), (g1, g2, g4, g6) = _class_idx(cfg)
    bps = cfg.bits_per_symbol
    n_sym = -(-n_bits // bps)
    pad_n = (1 + n_sym) * cfg.sym_len + cfg.preamble_len \
        + cfg.guard_samples + cfg.n_fft + 8
    rx_pad = jnp.concatenate(
        [rx.astype(jnp.float32), jnp.zeros(pad_n, jnp.float32)])

    def one(start):
        eqc, _h = _equalized_symbols(cfg, rx_pad, start, n_sym)
        parts = []
        if b1:
            s1 = eqc[:, jnp.asarray(b1)] / jnp.asarray(g1)
            parts.append((s1.real > 0).astype(jnp.uint8))
        if b2:
            parts.append(_qpsk_to_bits(
                eqc[:, jnp.asarray(b2)] / jnp.asarray(g2)))
        if b4:
            parts.append(_qam16_to_bits(
                eqc[:, jnp.asarray(b4)] / jnp.asarray(g4)))
        if b6:
            parts.append(_qam64_to_bits(
                eqc[:, jnp.asarray(b6)] / jnp.asarray(g6)))
        bits = jnp.concatenate(parts, axis=-1).reshape(-1)
        return bits[:n_bits]

    return jax.vmap(one)(jnp.asarray(starts, jnp.int32))


# --------------------------------------------------------------------------
# Channel probing and loading selection


@functools.lru_cache(maxsize=16)
def _probe_syms(cfg: OfdmAdaptiveConfig) -> np.ndarray:
    """Known uniform-QPSK probe data on every data bin."""
    rng = np.random.default_rng(cfg.probe_seed)
    n = cfg.probe_symbols * len(cfg.data_bin_idx) * 2
    return rng.integers(0, 2, n).astype(np.uint8)


def probe_waveform(cfg: OfdmAdaptiveConfig) -> np.ndarray:
    """chirp ‖ SC pilot ‖ probe_symbols of known QPSK on all data bins."""
    probe_cfg = dataclasses.replace(cfg, loading=(), gains=())  # uniform QPSK
    bits = jnp.asarray(_probe_syms(cfg)[None])
    return np.asarray(modulate_bits_adaptive(
        probe_cfg, bits, bits.shape[-1])[0])


@functools.partial(jax.jit, static_argnums=(0,))
def estimate_bin_snr(cfg: OfdmAdaptiveConfig, rx: jax.Array,
                     start) -> jax.Array:
    """Per-data-bin SNR (linear) from the probe frame at `start`."""
    probe_cfg = dataclasses.replace(cfg, loading=(), gains=())
    n_sym = cfg.probe_symbols
    pad_n = (1 + n_sym) * cfg.sym_len + cfg.preamble_len \
        + cfg.guard_samples + cfg.n_fft + 8
    rx_pad = jnp.concatenate(
        [rx.astype(jnp.float32), jnp.zeros(pad_n, jnp.float32)])
    eqc, _h = _equalized_symbols(probe_cfg, rx_pad,
                                 jnp.asarray(start, jnp.int32), n_sym)
    dbins = jnp.asarray(probe_cfg.data_bin_idx)
    got = eqc[:, dbins]                                 # (n_sym, n_data)
    want = _bits_to_qpsk(jnp.asarray(_probe_syms(cfg)).reshape(
        n_sym, -1))                                     # (n_sym, n_data)
    err = got - want
    # Separate the DETERMINISTIC equalizer bias a_k = H/H_est - 1 (the
    # per-bin channel-estimate error, fixed across symbols and scaling
    # with the transmitted amplitude) from the additive noise: a probe
    # that lumps them under-counts the bias for 16-QAM corner points
    # (|X|^2 = 1.8x the QPSK power used to probe), which measured as a
    # 2-6 dB SNR overestimate in steep roll-off bands.  Count the bias
    # at corner amplitude.
    sig = jnp.mean(jnp.abs(want) ** 2, axis=0)
    a = (jnp.sum(err * jnp.conj(want), axis=0)
         / jnp.maximum(jnp.sum(jnp.abs(want) ** 2, axis=0), 1e-12))
    noise = jnp.maximum(
        jnp.mean(jnp.abs(err - a[None, :] * want) ** 2, axis=0), 1e-12)
    eff_err = 1.8 * jnp.abs(a) ** 2 * sig + noise
    return sig / eff_err


def choose_loading(snr_linear: np.ndarray,
                   thresholds_db: tuple = (8.5, 14.0, 23.0, 29.5),
                   guard_bins: int = 2) -> tuple:
    """SNR-gap loading: bits/bin in {0,1,2,4,6}.

    Each bin is thresholded on the MINIMUM SNR over a +-guard_bins
    window.  Two measured failure modes motivate this (see the tests):
    the probe estimate carries ~1-2 dB of noise per bin, and in a
    steep roll-off transition band the smoothed channel estimate
    biases the probe's per-bin SNR up by 2-6 dB — the windowed min
    derates exactly where the SNR curve is steep (the penalty grows
    with the local slope), while flat in-band regions lose nothing.
    Thresholds sit ~4-6 dB above each constellation's hard-decision
    cliff; the 64-QAM tier is the 16-QAM threshold + 6.5 dB (minimum
    distance ratio 10*log10(42/10) = 6.2 dB, rounded up).  Pass a
    3-tuple to cap loading at 16-QAM."""
    snr = np.asarray(snr_linear)
    n = len(snr)
    robust = snr.copy()
    for d in range(1, guard_bins + 1):
        left = np.concatenate([snr[:d], snr[:-d]])
        right = np.concatenate([snr[d:], snr[-d:]])
        robust = np.minimum(robust, np.minimum(left, right))
    snr_db = 10.0 * np.log10(np.maximum(robust, 1e-12))
    tiers = (1, 2, 4, 6)[: len(thresholds_db)]
    lv = np.zeros(n, np.int32)
    for t_db, bits in zip(thresholds_db, tiers):
        lv[snr_db >= t_db] = bits
    return tuple(lv.tolist())


def quantize_gain(g: float) -> float:
    """Snap an amplitude gain to the handshake wire grid (0.25 dB
    steps, int8 range = +-31.75 dB) so transmitter and receiver use the
    bit-identical value.  pack_gains/unpack_gains round-trip exactly
    on these values."""
    q = int(np.clip(np.round(80.0 * np.log10(max(g, 1e-12))), -127, 127))
    return float(10.0 ** (q / 80.0))


def choose_gains(snr_linear: np.ndarray, loading: tuple,
                 thresholds_db: tuple = (8.5, 14.0, 23.0, 29.5),
                 max_gain_db: float = 6.0) -> tuple:
    """Water-filling (margin-balancing) per-bin transmit power on top
    of the discrete loading.

    The discrete {0,1,2,4}-bit grid strands margin unevenly: a bin at
    14.1 dB carries QPSK with 0.1 dB to spare while a 22.9 dB bin
    carries the same QPSK with 8.9 dB of headroom.  Classic DMT margin
    maximization fixes this: give each ACTIVE bin power proportional
    to req(b_k)/SNR_k — after scaling, every active bin sits at its
    constellation threshold plus the SAME margin, so the weakest bins
    (where the Viterbi error events start) gain what the strongest
    donate.  Total transmit power over active bins is conserved
    (sum g^2 = n_active, the uniform budget), per-bin power is clipped
    to +-max_gain_db (PAPR / speaker-excursion guard; the water level
    re-rises among unclipped bins via bisection), and gains are
    quantized to the handshake grid.  Inactive bins get gain 1.0 as a
    placeholder (the modulator never writes them).
    """
    snr = np.maximum(np.asarray(snr_linear, np.float64), 1e-12)
    lv = np.asarray(loading, np.int64)
    assert len(lv) == len(snr), (len(lv), len(snr))
    active = lv > 0
    n_act = int(active.sum())
    if n_act == 0:
        return tuple([1.0] * len(lv))
    t1, t2, t4 = thresholds_db[:3]
    t6 = thresholds_db[3] if len(thresholds_db) > 3 else t4 + 6.5
    req_db = np.where(lv == 1, t1, np.where(lv == 2, t2,
                      np.where(lv == 4, t4, t6)))
    req = 10.0 ** (req_db / 10.0)
    p_des = np.where(active, req / snr, 0.0)
    p_lo = 10.0 ** (-max_gain_db / 10.0)
    p_hi = 10.0 ** (max_gain_db / 10.0)

    def total(s: float) -> float:
        return float(np.clip(s * p_des[active], p_lo, p_hi).sum())

    lo, hi = 1e-9, 1e9
    for _ in range(60):                    # bisect the water level
        mid = np.sqrt(lo * hi)
        if total(mid) < n_act:
            lo = mid
        else:
            hi = mid
    p = np.where(active, np.clip(lo * p_des, p_lo, p_hi), 1.0)
    return tuple(quantize_gain(float(np.sqrt(v))) for v in p)


def pack_gains(gains: tuple) -> bytes:
    """Gains -> one signed byte per data bin (0.25 dB steps)."""
    out = bytearray()
    for g in gains:
        q = int(np.clip(np.round(80.0 * np.log10(max(float(g), 1e-12))),
                        -127, 127))
        out.append(q & 0xFF)
    return bytes(out)


def unpack_gains(data: bytes, n_bins: int) -> tuple:
    qs = [(b - 256 if b >= 128 else b) for b in data[:n_bins]]
    return tuple(float(10.0 ** (q / 80.0)) for q in qs)


def pack_loading(loading: tuple) -> bytes:
    """Loading -> compact bytes for the handshake frame: one nibble
    code per data bin (0,1,2,4,6 bits -> codes 0..4), 2 bins/byte,
    high nibble first."""
    code = {0: 0, 1: 1, 2: 2, 4: 3, 6: 4}
    lv = [code[int(v)] for v in loading]
    if len(lv) % 2:
        lv.append(0)
    out = bytearray()
    for i in range(0, len(lv), 2):
        out.append((lv[i] << 4) | lv[i + 1])
    return bytes(out)


def unpack_loading(data: bytes, n_bins: int) -> tuple:
    bits = {0: 0, 1: 1, 2: 2, 3: 4, 4: 6}
    lv = []
    for byte in data:
        lv.append(bits[byte >> 4])
        lv.append(bits[byte & 0xF])
    return tuple(lv[:n_bins])


class OfdmAdaptiveStreamPhy:
    """MAC-capable adaptive-loading coded PHY — the duck type of
    :class:`trackmaker_tpu.phy.ofdm_v2.OfdmStreamPhyV2`
    (``encode_frames`` / ``process_samples`` / ``reset`` /
    ``frame_samples``), so CSMA/ARQ/GBN run unchanged over it.

    Loading handshake (fixed-loading, ADSL-style): both ends construct
    with the same loading tuple.  In a live link the receiver probes
    (:func:`probe_waveform` -> :func:`estimate_bin_snr` ->
    :func:`choose_loading`), packs the result with
    :func:`pack_loading` into a regular data frame sent back over the
    robust uniform-QPSK default (``loading=()``), and both sides then
    switch — see ``tests/test_ofdm_adaptive_mac.py::test_handshake``.

    FEC: every frame is rate-1/2 K=7 conv-coded (core/convcode.py) as
    two independently flushed blocks — header (56 bits -> 124 coded)
    then payload (8L -> 16L+12 coded) — so the frame length Viterbi-
    decodes from a short prefix before the payload block's symbols are
    touched.  Decoding is soft-decision: max-log per-bit values from
    :func:`soft_demodulate_at_adaptive` weight the Viterbi branch
    metrics by subcarrier reliability, which is what makes coded
    16-QAM on shaped channels beat uncoded QPSK at equal net
    throughput (the Viterbi path discounts the weak bins the loading
    kept at 1-2 bits)."""

    HDR_BITS = 56
    HDR_CODED = 2 * (56 + 6)          # 124

    @staticmethod
    def _perm(m: int) -> np.ndarray:
        """Coded-bit interleaver (core/convcode.py:block_interleaver):
        contiguous roll-off bins would otherwise hand the Viterbi
        decoder bursts beyond its ~K-bit memory."""
        from trackmaker_tpu.core.convcode import block_interleaver
        return block_interleaver(m)

    def __init__(self, cfg: OfdmAdaptiveConfig = OfdmAdaptiveConfig(),
                 loading: tuple | None = None,
                 max_frame_bytes: int = 263,
                 local_addr: int | None = None,
                 gains: tuple | None = None):
        if loading is not None:
            cfg = dataclasses.replace(cfg, loading=tuple(loading))
        if gains is not None:
            cfg = dataclasses.replace(cfg, gains=tuple(gains))
        assert cfg.bits_per_symbol >= 1, "loading disables every bin"
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.max_syms = cfg.n_symbols(
            self._coded_bits(max_frame_bytes - 7))
        self._buf = np.zeros(0, np.float32)
        self.preamble_len = cfg.preamble_len
        # pre-FEC BER history, one entry per decode attempt (see
        # prefec_ber / link_degraded): the live re-probe trigger
        self.frame_prefec: list[float] = []

    @staticmethod
    def _coded_bits(n_payload_bytes: int) -> int:
        return (OfdmAdaptiveStreamPhy.HDR_CODED
                + 2 * (8 * n_payload_bytes + 6))

    @property
    def net_bits_per_symbol(self) -> float:
        """Information bits per OFDM symbol after the rate-1/2 code —
        the number to compare against an uncoded PHY's
        ``bits_per_symbol`` for equal-throughput comparisons."""
        return self.cfg.bits_per_symbol / 2.0

    @classmethod
    def handshake_mode(cls, cfg: OfdmAdaptiveConfig = OfdmAdaptiveConfig(),
                       local_addr: int | None = None
                       ) -> "OfdmAdaptiveStreamPhy":
        """The a-priori negotiation mode: coded BPSK on the lowest
        quarter of the data bins only.  Like ADSL's C-MSGS channel, the
        handshake must survive a channel NOBODY has probed yet, so it
        runs on the sub-band acoustic channels rarely kill (speaker/mic
        roll-off hits the top of the band) at the most robust
        constellation.  Both ends construct this mode by convention,
        exchange the probe-chosen loading inside an ordinary data frame
        (:func:`pack_loading`), then switch to the loaded mode."""
        n = len(cfg.data_bin_idx)
        lv = tuple([1] * (n // 4) + [0] * (n - n // 4))
        return cls(cfg, loading=lv, local_addr=local_addr)

    # -- encoder side --------------------------------------------------

    def encode_frame(self, frame: Frame) -> np.ndarray:
        from trackmaker_tpu.core import bitops
        from trackmaker_tpu.core.convcode import conv_encode
        fb = frame.to_bytes()
        hdr = bitops.bytes_to_bits_host(fb[:7])
        pay = bitops.bytes_to_bits_host(fb[7:]) if len(fb) > 7 \
            else np.zeros(0, np.uint8)
        ch = np.asarray(conv_encode(jnp.asarray(hdr)))
        cp = np.asarray(conv_encode(jnp.asarray(pay)))
        coded = np.concatenate(
            [ch[self._perm(len(ch))], cp[self._perm(len(cp))]])
        w = modulate_bits_adaptive(self.cfg, jnp.asarray(coded[None]),
                                   int(coded.shape[-1]))
        return np.asarray(w[0])

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        parts = []
        for i, f in enumerate(frames):
            parts.append(self.encode_frame(f))
            if i < len(frames) - 1:
                parts.append(np.zeros(gap_samples, np.float32))
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    # -- streaming decoder side ----------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def frame_samples(self, n_payload: int) -> int:
        return self.cfg.frame_samples(self._coded_bits(n_payload))

    # -- link-quality monitoring (the live re-probe trigger) -----------

    @staticmethod
    def _prefec(soft_coded: np.ndarray, decoded_bits: np.ndarray
                ) -> float:
        """Pre-FEC BER estimate by re-encoding the Viterbi output and
        comparing against the hard decisions of the received soft
        values (the standard syndrome-free BER monitor: with the code
        operating inside its correction radius the re-encoded stream
        IS the transmitted stream, so mismatches are channel bit
        errors)."""
        from trackmaker_tpu.core.convcode import conv_encode
        ref = np.asarray(conv_encode(jnp.asarray(decoded_bits)))
        hard = (soft_coded > 0).astype(np.uint8)
        return float(np.mean(hard != ref[: len(hard)]))

    def prefec_ber(self, window: int = 8) -> float:
        """Mean pre-FEC BER over the last `window` decode attempts
        (NaN-free: 0.0 until anything was decoded)."""
        h = self.frame_prefec[-window:]
        return float(np.mean(h)) if h else 0.0

    def link_degraded(self, threshold: float = 0.04,
                      window: int = 8) -> bool:
        """True when the recent pre-FEC BER says the current loading no
        longer fits the channel.  Rate-1/2 K=7 soft Viterbi corrects
        ~4-5% channel BER reliably; beyond that CRC failures (and ARQ
        storms) follow, so 4% is the re-probe trip point — fire the
        ADSL-style retrain (``retrain_frames`` / ``parse_control``)
        before the link actually drops."""
        return (len(self.frame_prefec) >= window
                and self.prefec_ber(window) >= threshold)

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        from trackmaker_tpu.core.convcode import viterbi_decode
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
            if s + cfg.frame_samples(self.HDR_CODED) > len(self._buf):
                break  # header symbols still arriving
            soft_h = np.asarray(soft_demodulate_at_adaptive(
                cfg, pj, self.HDR_CODED, jnp.asarray([s])))[0]
            # TX sent wire[i] = coded[perm[i]]; restore coded order
            deint = np.empty_like(soft_h)
            deint[self._perm(self.HDR_CODED)] = soft_h
            hdr_bits = np.asarray(viterbi_decode(
                jnp.asarray(deint), self.HDR_BITS, soft=True))
            hdr = np.packbits(hdr_bits)
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - 7:
                self.frame_prefec.append(self._prefec(deint, hdr_bits))
                consumed = s + cfg.preamble_len
                continue
            total_coded = self._coded_bits(data_len)
            frame_end = s + cfg.frame_samples(total_coded)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            soft = np.asarray(soft_demodulate_at_adaptive(
                cfg, pj, self.max_syms * cfg.bits_per_symbol,
                jnp.asarray([s])))[0]
            pay_coded = soft[self.HDR_CODED: total_coded]
            if data_len:
                pdeint = np.empty_like(pay_coded)
                pdeint[self._perm(len(pay_coded))] = pay_coded
                pay_bits = np.asarray(viterbi_decode(
                    jnp.asarray(pdeint), 8 * data_len, soft=True))
            else:
                pay_bits = np.zeros(0, np.uint8)
            f = Frame.from_bits(np.concatenate([hdr_bits, pay_bits]))
            if data_len:
                self.frame_prefec.append(0.5 * (
                    self._prefec(deint, hdr_bits)
                    + self._prefec(pdeint, pay_bits)))
            else:
                self.frame_prefec.append(self._prefec(deint, hdr_bits))
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

    # -- batched device decode (equal-length frames) ---------------------

    def batched_decode_fn(self, n_frames: int, payload_len: int):
        """Build a jittable ``x[B, T] -> (starts[B, F], bits[B, F,
        56 + 8*payload_len])`` batch decoder for equal-length adaptive
        coded frames: chirp sync, loading-aware soft demap, static
        inverse-interleave, soft Viterbi per block — one fixed-shape
        program (the throughput path the bench's `ofdm_adaptive` row
        measures; `process_samples` stays the streaming MAC spec)."""
        from trackmaker_tpu.core.convcode import viterbi_decode

        cfg = self.cfg
        total_coded = self._coded_bits(payload_len)
        pay_coded = total_coded - self.HDR_CODED
        n_pay_bits = 8 * payload_len
        inv_h = np.argsort(self._perm(self.HDR_CODED))
        inv_p = np.argsort(self._perm(pay_coded))
        # static-permutation deinterleave as a one-hot matmul (exact
        # f32 pick at HIGHEST — see phy/coded.py)
        pm_h = np.zeros((self.HDR_CODED, self.HDR_CODED), np.float32)
        pm_h[np.arange(self.HDR_CODED), inv_h] = 1.0
        pm_p = np.zeros((pay_coded, pay_coded), np.float32)
        pm_p[np.arange(pay_coded), inv_p] = 1.0

        def deint(s, pm):
            return jnp.einsum("...j,ij->...i", s, jnp.asarray(pm),
                              precision=jax.lax.Precision.HIGHEST)

        def one(rx):
            starts = find_preambles(cfg, rx, n_frames)
            soft = soft_demodulate_at_adaptive(
                cfg, rx, total_coded,
                jnp.maximum(starts, 0))             # (F, total_coded)
            hdr = jax.vmap(lambda s: viterbi_decode(
                s, self.HDR_BITS, soft=True))(
                    deint(soft[:, :self.HDR_CODED], pm_h))
            pay = jax.vmap(lambda s: viterbi_decode(
                s, n_pay_bits, soft=True))(
                    deint(soft[:, self.HDR_CODED:total_coded], pm_p))
            return starts, jnp.concatenate([hdr, pay], axis=-1)

        return jax.jit(jax.vmap(one))

    def decode_equal_frames(self, caps: np.ndarray, n_frames: int,
                            payload_len: int) -> list[list[Frame]]:
        """Host facade over :meth:`batched_decode_fn`; returns
        per-capture CRC-valid Frame lists."""
        fn = self.batched_decode_fn(n_frames, payload_len)
        starts, bits = fn(jnp.asarray(caps, jnp.float32))
        starts, bits = np.asarray(starts), np.asarray(bits)
        out: list[list[Frame]] = []
        for b in range(bits.shape[0]):
            row = []
            for k in range(bits.shape[1]):
                if starts[b, k] < 0:
                    continue
                f = Frame.from_bits(bits[b, k])
                if f is None:
                    continue
                if (self.local_addr is not None
                        and f.dst != self.local_addr):
                    continue
                row.append(f)
            out.append(row)
        return out


# --------------------------------------------------------------------------
# Live retrain protocol (loading refresh on link degradation)
#
# When OfdmAdaptiveStreamPhy.link_degraded() fires mid-session (the
# pre-FEC BER monitor says the negotiated loading no longer fits the
# channel), the receiver retrains ADSL-style without tearing the link
# down:
#
#   1. receiver -> transmitter (robust handshake mode): REPROBE request
#   2. transmitter emits probe_waveform(cfg)
#   3. receiver: estimate_bin_snr -> choose_loading -> LOADING update
#      frame (robust mode)
#   4. both ends switch their loaded PHYs to the new loading
#
# Control frames are ordinary data frames with a 2-byte magic payload
# prefix (the same in-band-magic convention as the reference router's
# ICMP traversal bytes 0xaa/0xbb, src/net/router.rs:1706-1779), so
# they need no frame-format change and pass through any MAC.

CTRL_REPROBE = b"\xa5R"
CTRL_LOADING = b"\xa5L"


def make_reprobe_frame(seq: int, src: int, dst: int) -> Frame:
    return Frame.new_data(seq, src, dst, CTRL_REPROBE)


def make_loading_frame(seq: int, src: int, dst: int,
                       loading: tuple,
                       gains: tuple | None = None) -> Frame:
    """LOADING update: the 2-bit/bin loading codes, optionally followed
    by one byte/bin of water-filling gains (pack_gains)."""
    body = CTRL_LOADING + pack_loading(loading)
    if gains is not None:
        body += pack_gains(gains)
    return Frame.new_data(seq, src, dst, body)


def parse_control(frame: Frame, n_bins: int):
    """-> ("reprobe", None, None) | ("loading", loading, gains|None)
    | None.  gains is None when the frame carries no gain bytes (a
    loading-only update keeps unit power)."""
    if frame.data[:2] == CTRL_REPROBE and len(frame.data) == 2:
        return ("reprobe", None, None)
    if frame.data[:2] == CTRL_LOADING:
        rest = frame.data[2:]
        n_lb = -(-n_bins // 2)            # loading bytes, 2 bins/byte
        loading = unpack_loading(rest[:n_lb], n_bins)
        gains = (unpack_gains(rest[n_lb:], n_bins)
                 if len(rest) >= n_lb + n_bins else None)
        return ("loading", loading, gains)
    return None


class OfdmAdaptiveModem:
    """Frame-level facade: probe -> loading -> loaded encode/decode.

    Workflow (both ends must share the loading; in a live link the
    receiver would probe and feed the loading back over a robust
    low-rate channel, like ADSL's handshake):

        probe = probe_waveform(cfg)          # transmitter sends this
        snr = estimate_bin_snr(cfg, rx, s)   # receiver measures
        modem = OfdmAdaptiveModem(cfg, loading=choose_loading(snr))
    """

    def __init__(self, cfg: OfdmAdaptiveConfig = OfdmAdaptiveConfig(),
                 loading: tuple | None = None,
                 gains: tuple | None = None):
        if loading is not None:
            cfg = dataclasses.replace(cfg, loading=tuple(loading))
        if gains is not None:
            cfg = dataclasses.replace(cfg, gains=tuple(gains))
        assert cfg.bits_per_symbol >= 1, "loading disables every bin"
        self.cfg = cfg

    @property
    def bits_per_symbol(self) -> int:
        return self.cfg.bits_per_symbol

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        from trackmaker_tpu.core import bitops
        assert frames
        nb = {len(f.to_bytes()) * 8 for f in frames}
        assert len(nb) == 1, "group equal-length frames"
        bits = jnp.asarray(np.stack(
            [bitops.bytes_to_bits_host(f.to_bytes()) for f in frames]))
        waves = np.asarray(modulate_bits_adaptive(
            self.cfg, bits, nb.pop()))
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
        bits = np.asarray(demodulate_at_adaptive(
            self.cfg, jnp.asarray(rx), n_bits, jnp.asarray(starts)))
        out = []
        for row in bits:
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
