"""Acoustic OFDM modem — batched IFFT/FFT over subcarriers (BASELINE
config 2).

The reference stack is single-carrier (Manchester/4B5B baseband and the
ASK example); OFDM appears in its vendored study material
(``assets/psk.cxx``, fldigi) but was never built.  The north star
explicitly asks for the OFDM path as batched FFT/IFFT array programs, so
this is a from-scratch batched design:

* DMT-style real-valued OFDM: data subcarriers are placed on FFT bins
  inside an acoustic passband (default 2..10 kHz at 48 kHz/512-point
  FFT), the time signal is produced by a Hermitian-symmetric IFFT — one
  batched ``jnp.fft.irfft`` over all symbols of all frames at once.
* QPSK subcarrier mapping (Gray-coded), cyclic prefix against echo.
* Chirp preamble (shared with the ASK modem) for coarse sync via the
  shared correlator, then a known BPSK pilot symbol gives the
  per-bin complex channel estimate; payload symbols are FFT'd, equalized
  (one-tap per bin), and demapped — all vmapped.
* Framing reuses the PHY frame codec (CRC8 + [Len|CRC|Type|Seq|Src|Dst]),
  so the MAC/NET layers run unchanged over the OFDM PHY.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core import bitops, blockq
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.dsp.osc import chirp_cached


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    sample_rate: int = 48_000
    n_fft: int = 512
    cp_len: int = 128
    bin_lo: int = 22            # ~2.06 kHz
    bin_hi: int = 107           # ~10.03 kHz (exclusive)
    bits_per_sym: int = 2       # QPSK
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    pilot_seed: int = 7
    amplitude: float = 0.5      # time-domain scaling headroom
    sync_threshold: float = 0.5  # normalized chirp correlation
    guard_samples: int = 64     # silence between preamble and first symbol

    @property
    def n_bins(self) -> int:
        return self.bin_hi - self.bin_lo

    @property
    def bits_per_symbol(self) -> int:
        return self.n_bins * self.bits_per_sym

    @property
    def sym_len(self) -> int:
        return self.n_fft + self.cp_len

    def n_symbols(self, n_bits: int) -> int:
        return -(-n_bits // self.bits_per_symbol)

    def frame_samples(self, n_bits: int) -> int:
        """preamble + guard + pilot + data symbols."""
        return (self.preamble_len + self.guard_samples
                + (1 + self.n_symbols(n_bits)) * self.sym_len)


def _pilot_symbols(cfg: OfdmConfig) -> np.ndarray:
    """Deterministic BPSK pilot per data bin (channel estimation)."""
    rng = np.random.default_rng(cfg.pilot_seed)
    return (2.0 * rng.integers(0, 2, cfg.n_bins) - 1.0).astype(np.complex64)


_QPSK = np.asarray(  # Gray-coded: b1b0 -> constellation point / sqrt(2)
    [1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], dtype=np.complex64) / np.sqrt(2)


def _bits_to_qpsk(bits: jax.Array) -> jax.Array:
    """uint8[..., 2k] -> complex64[..., k] Gray-mapped QPSK."""
    pairs = bits.reshape(*bits.shape[:-1], -1, 2).astype(jnp.int32)
    idx = pairs[..., 0] * 2 + pairs[..., 1]
    return jnp.asarray(_QPSK)[idx]


def _qpsk_to_bits(sym: jax.Array) -> jax.Array:
    """Hard decision, inverse of _bits_to_qpsk."""
    # idx = 2*b0 + b1 over _QPSK: real sign encodes b1, imag sign b0
    b0 = (sym.imag < 0).astype(jnp.uint8)
    b1 = (sym.real < 0).astype(jnp.uint8)
    return jnp.stack([b0, b1], axis=-1).reshape(*sym.shape[:-1], -1)


def _spectrum_to_time(cfg: OfdmConfig, subcarriers: jax.Array) -> jax.Array:
    """complex[..., n_bins] -> real time symbols [..., sym_len] with CP."""
    shape = (*subcarriers.shape[:-1], cfg.n_fft // 2 + 1)
    spec = jnp.zeros(shape, jnp.complex64)
    spec = spec.at[..., cfg.bin_lo:cfg.bin_hi].set(subcarriers)
    time = jnp.fft.irfft(spec, n=cfg.n_fft, axis=-1) * (
        cfg.amplitude * cfg.n_fft / max(cfg.n_bins, 1))
    cp = time[..., -cfg.cp_len:]
    return jnp.concatenate([cp, time], axis=-1).astype(jnp.float32)


def _time_to_spectrum(cfg: OfdmConfig, symbols: jax.Array) -> jax.Array:
    """real[..., sym_len] -> complex[..., n_bins] (CP stripped)."""
    body = symbols[..., cfg.cp_len:]
    spec = jnp.fft.rfft(body, n=cfg.n_fft, axis=-1)
    return spec[..., cfg.bin_lo:cfg.bin_hi]


@functools.partial(jax.jit, static_argnums=(0, 2))
def modulate_bits(cfg: OfdmConfig, bits: jax.Array,
                  n_bits: int) -> jax.Array:
    """uint8[B, n_bits] -> f32[B, frame_samples]: chirp ‖ guard ‖ pilot ‖
    QPSK data symbols."""
    b = bits.shape[0]
    n_sym = cfg.n_symbols(n_bits)
    pad = n_sym * cfg.bits_per_symbol - n_bits
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    qpsk = _bits_to_qpsk(bits).reshape(b, n_sym, cfg.n_bins)
    pilot = jnp.broadcast_to(
        jnp.asarray(_pilot_symbols(cfg)), (b, 1, cfg.n_bins))
    subs = jnp.concatenate([pilot, qpsk], axis=1)     # (B, 1+n_sym, n_bins)
    t_syms = _spectrum_to_time(cfg, subs)             # (B, 1+n_sym, sym_len)
    body = t_syms.reshape(b, -1)
    pre = jnp.asarray(chirp_cached(
        cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz, cfg.sample_rate))
    pre = jnp.broadcast_to(pre, (b, cfg.preamble_len))
    guard = jnp.zeros((b, cfg.guard_samples), jnp.float32)
    return jnp.concatenate([pre, guard, body], axis=-1)


def _windows_spectrum(cfg: OfdmConfig, rx: jax.Array, starts: jax.Array,
                      n_sym: int) -> jax.Array:
    """FFT spectra of the pilot + data symbol bodies at each start:
    f32[T], int32[B] -> complex64[B, 1+n_sym, n_bins].

    Gather-free windowing: a per-frame
    ``dynamic_slice(pad, (start + body_off,), (total,))`` with traced
    starts lowers (under the callers' vmap) to per-element gathers.
    Instead the receiver applies the standard OFDM timing
    back-off: every symbol's FFT window within one frame shares the
    same offset mod 32 (``sym_len`` is a multiple of 32), so fetching
    each window at the 32-aligned position — delta in [0, 32) samples
    EARLY, i.e. inside that symbol's cyclic prefix, never crossing
    into the previous symbol since delta < cp_len — keeps the fetch
    to two ~free 512-aligned row-gathers plus a hierarchical 4x4
    static select (two levels of 3 lane-shifted ``where`` passes; a
    flat 16-way select would pay 15).  The back-off would multiply
    every bin by the phase ramp exp(-2i pi k delta / n_fft); delta is
    known exactly, so the conjugate ramp is applied before returning
    and callers receive the NOMINAL-window spectrum (bit-identical
    statistics in AWGN, and cross-bin smoothers — ofdm_v2's channel
    estimate — see no timing artifact).  Under multipath the back-off COSTS
    late-echo guard when sync locks the first arrival: a window
    starting delta early tolerates echo delay cp_len - delta instead
    of cp_len, which is why the granularity is 32 and not 128 (128
    would leave a worst case of cp_len - 127 = 1 sample; 32 keeps
    >= cp_len - 31 = 97 at the default cp).
    test_ofdm.py::test_demodulate_windows_match_slices pins the fetch
    against dynamic slices at the same back-off positions, and
    test_ofdm.py::test_ofdm_multipath_echo covers the echo guard.

    Configs that don't satisfy the alignment preconditions (cp_len >=
    32 and sym_len % 32 == 0 — e.g. a custom cp_len=24) fall back to
    the exact per-frame dynamic-slice fetch at the nominal (zero
    back-off) window positions: correct for any config, just not on
    the gather-free fast path."""
    body_off = cfg.preamble_len + cfg.guard_samples
    nst = 1 + n_sym
    b = starts.shape[0]
    t = rx.shape[-1]
    o = starts.astype(jnp.int32) + body_off
    if not (cfg.cp_len >= 32 and cfg.sym_len % 32 == 0):
        # exact fallback: nominal windows via per-frame dynamic slices
        pad = jnp.concatenate([
            rx.astype(jnp.float32),
            jnp.zeros(body_off + nst * cfg.sym_len + cfg.n_fft + 8,
                      jnp.float32)])

        def one(start):
            seg = jax.lax.dynamic_slice(
                pad, (jnp.maximum(start, 0),), (nst * cfg.sym_len,))
            body = seg.reshape(nst, cfg.sym_len)[:, cfg.cp_len:]
            return jnp.fft.rfft(body, n=cfg.n_fft, axis=-1)

        spec = jax.vmap(one)(o)
        return spec[..., cfg.bin_lo:cfg.bin_hi]
    r_ = 512
    hi = t + body_off + nst * cfg.sym_len + 2 * r_
    nrows = -(-hi // r_)
    rows = jnp.pad(rx.astype(jnp.float32),
                   (0, nrows * r_ - t)).reshape(nrows, r_)
    wpos = (o[:, None] + jnp.arange(nst, dtype=jnp.int32)[None, :]
            * cfg.sym_len + cfg.cp_len).reshape(-1)     # [B*nst]
    aligned = (wpos // 32) * 32                         # back-off into CP
    jb = aligned // r_
    c4 = (aligned % r_) // 128                          # coarse: 128-step
    f4 = (aligned % 128) // 32                          # fine: 32-step
    n_need = (cfg.n_fft + r_ - 1) // r_ + 1
    src = rows[jb[:, None] + jnp.arange(n_need, dtype=jnp.int32)[None, :]]
    src = src.reshape(-1, n_need * r_)
    wfft = cfg.n_fft + 96                               # covers fine shifts
    wide = src[:, :wfft]
    for i in range(1, 4):                               # 128-aligned slices
        wide = jnp.where((c4 == i)[:, None],
                         src[:, 128 * i: 128 * i + wfft], wide)
    body = wide[:, :cfg.n_fft]
    for j in range(1, 4):                               # 32-aligned slices
        body = jnp.where((f4 == j)[:, None],
                         wide[:, 32 * j: 32 * j + cfg.n_fft], body)
    spec = jnp.fft.rfft(body, n=cfg.n_fft, axis=-1)
    spec = spec[..., cfg.bin_lo:cfg.bin_hi]
    # De-ramp the back-off: a window fetched delta samples early sees
    # the body circularly shifted (within the CP), i.e. bin k scaled by
    # exp(-2i pi k delta / n_fft).  Multiplying by the conjugate ramp
    # returns the NOMINAL-window spectrum exactly, so smoothing /
    # cross-bin channel estimators downstream (ofdm_v2's 9-bin moving
    # average would attenuate a 31-sample ramp's phasor to ~0.6, and a
    # compounded SC-early + delta ramp to ~0.04)
    # see no timing artifact at all.
    delta = (wpos - aligned).astype(jnp.float32)        # [B*nst] in [0,32)
    k_abs = jnp.arange(cfg.bin_lo, cfg.bin_hi, dtype=jnp.float32)
    ramp = jnp.exp(1j * (2.0 * jnp.pi / cfg.n_fft)
                   * delta[:, None] * k_abs[None, :]).astype(jnp.complex64)
    return (spec * ramp).reshape(b, nst, cfg.n_bins)


@functools.partial(jax.jit, static_argnums=(0, 2))
def demodulate_soft_at(cfg: OfdmConfig, rx: jax.Array, n_bits: int,
                       starts: jax.Array) -> jax.Array:
    """Soft bit metrics in [-1, 1] (positive = bit 1) for frames whose
    preambles start at `starts` — feeds the soft-decision Viterbi."""
    n_sym = cfg.n_symbols(n_bits)
    all_spec = _windows_spectrum(cfg, rx, jnp.asarray(starts, jnp.int32),
                                 n_sym)

    def one(spec):
        pilot_rx = spec[0]
        h = pilot_rx * jnp.conj(jnp.asarray(_pilot_symbols(cfg)))
        h = jnp.where(jnp.abs(h) < 1e-12, 1.0 + 0j, h)
        scale = jnp.mean(jnp.abs(h))
        eq = spec[1:] * jnp.conj(h) / jnp.maximum(jnp.abs(h), 1e-12)
        eqf = eq.reshape(-1) / jnp.maximum(scale, 1e-12)
        # bit pair per symbol: b0 from -imag, b1 from -real (see _QPSK)
        soft = jnp.stack([-eqf.imag, -eqf.real], axis=-1).reshape(-1)
        return jnp.clip(soft * np.sqrt(2.0), -1.0, 1.0)[:n_bits]

    return jax.vmap(one)(all_spec)


@functools.partial(jax.jit, static_argnums=(0, 2))
def demodulate_at(cfg: OfdmConfig, rx: jax.Array, n_bits: int,
                  starts: jax.Array) -> jax.Array:
    """Demodulate frames whose *preamble* starts at `starts` (int[B]) in
    rx[T] -> uint8[B, n_bits].  Equalizes each bin by the pilot estimate
    (one complex tap), so flat-ish channel gain/phase/echo is absorbed."""
    n_sym = cfg.n_symbols(n_bits)
    all_spec = _windows_spectrum(cfg, rx, jnp.asarray(starts, jnp.int32),
                                 n_sym)

    def one(spec):
        pilot_rx = spec[0]
        h = pilot_rx * jnp.conj(jnp.asarray(_pilot_symbols(cfg)))
        h = jnp.where(jnp.abs(h) < 1e-12, 1.0 + 0j, h)
        eq = spec[1:] * jnp.conj(h) / jnp.maximum(jnp.abs(h), 1e-12) ** 1
        bits = _qpsk_to_bits(eq.reshape(-1))
        return bits[:n_bits]

    return jax.vmap(one)(all_spec)


def find_preambles(cfg: OfdmConfig, rx: jax.Array,
                   max_frames: int = 64) -> jax.Array:
    """Coarse chirp sync: normalized correlation peaks separated by at
    least one frame's preamble; returns int32[max_frames] starts (-1 pad).
    """
    from trackmaker_tpu import sync as sync_mod
    pre = chirp_cached(cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz,
                       cfg.sample_rate)
    corr = sync_mod.normalized_xcorr(rx, pre)
    t = corr.shape[-1]
    hits = corr >= cfg.sync_threshold
    # block-bitmap first-hit queries: the previous form rescanned the
    # whole capture per scan step (argmax over hits & (idx >= cursor)
    # is O(T) x max_frames); each block query touches one 512-lane row
    tables = blockq.block_tables(hits)
    w = cfg.preamble_len
    # Refine via aligned-row fetch + masked argmax: the previous
    # dynamic_slice(corr_pad, (first,), (w,)) with a traced start
    # lowers (under the callers' vmap) to per-element gathers at
    # ~2-21 ns/element (CLAUDE.md), i.e. ~0.45M gathered elements per
    # batch-32 call; whole 512-lane row-gathers are ~free.  Masking
    # lanes to [off, off+w) keeps both the values and argmax's
    # first-tie order, so the refined peak is exactly unchanged.
    r_ = 512
    n_need = (w + r_ - 1) // r_ + 1         # rows covering any offset
    nrows = -(-(t + w) // r_) + n_need
    rows = jnp.pad(corr, (0, nrows * r_ - t)).reshape(nrows, r_)
    lane = jnp.arange(n_need * r_, dtype=jnp.int32)

    def step(carry, _):
        cursor, done = carry
        first, has = blockq.first_set_from(tables, cursor)
        first = jnp.where(has, first, 0)   # same slice as argmax-of-none
        # refine: argmax of corr within one preamble of the crossing
        jb, off = first // r_, first % r_
        win = jnp.concatenate([rows[jb + i] for i in range(n_need)])
        ok = (lane >= off) & (lane < off + w)
        peak = jb * r_ + jnp.argmax(jnp.where(ok, win, -jnp.inf))
        start = peak
        new_cursor = peak + cfg.preamble_len
        out = jnp.where(has & ~done, start, -1)
        return (jnp.where(has, new_cursor, cursor), done | ~has), out

    # carry derives from rx so the scan stays typeable under shard_map
    # (a constant-initial carry is unvarying while the body output
    # varies over the mesh axis — same trick as decode_capture's vlen)
    zero = (rx[0] * 0).astype(jnp.int32)
    (_, _), starts = jax.lax.scan(
        step, (zero, zero > 0), None, length=max_frames,
        unroll=min(8, max_frames))
    return starts


@functools.partial(jax.jit, static_argnums=(0, 1))
def _demod_symbols_at(cfg: OfdmConfig, max_syms: int, rx: jax.Array,
                      start: jax.Array) -> jax.Array:
    """Demod pilot + up to max_syms data symbols at one preamble start
    -> uint8[max_syms * bits_per_symbol] hard bits."""
    total = (1 + max_syms) * cfg.sym_len
    body_off = cfg.preamble_len + cfg.guard_samples
    pad = jnp.concatenate([rx.astype(jnp.float32),
                           jnp.zeros(total + body_off + 8, jnp.float32)])
    seg = jax.lax.dynamic_slice(
        pad, (jnp.clip(start, 0) + body_off,), (total,))
    syms = seg.reshape(1 + max_syms, cfg.sym_len)
    spec = _time_to_spectrum(cfg, syms)
    pilot_rx = spec[0]
    h = pilot_rx * jnp.conj(jnp.asarray(_pilot_symbols(cfg)))
    h = jnp.where(jnp.abs(h) < 1e-12, 1.0 + 0j, h)
    eq = spec[1:] * jnp.conj(h) / jnp.maximum(jnp.abs(h), 1e-12)
    return _qpsk_to_bits(eq.reshape(-1))


class OfdmStreamPhy:
    """Variable-length OFDM PHY with the line-coded PHY's duck type
    (``encode_frames`` / ``process_samples`` / ``reset``), so the MAC
    (CSMA/ARQ/GBN) and everything above it run unchanged over OFDM.

    Length handling: the first data symbol carries >= the 56-bit frame
    header, so decode demodulates pilot+all symbols up to the max frame
    size once per detection, parses the length from the leading bits,
    and keeps exactly (7+len)*8 bits — pad-and-mask, no second pass.
    """

    def __init__(self, cfg: OfdmConfig = OfdmConfig(),
                 max_frame_bytes: int = 263, local_addr: int | None = None):
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.max_syms = cfg.n_symbols(max_frame_bytes * 8)
        self._buf = np.zeros(0, np.float32)
        self.preamble_len = cfg.preamble_len

    # -- encoder side ------------------------------------------------------

    def encode_frame(self, frame: Frame) -> np.ndarray:
        bits = bitops.bytes_to_bits_host(frame.to_bytes())
        w = modulate_bits(self.cfg, jnp.asarray(bits[None]),
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

    # -- streaming decoder side ---------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def frame_samples(self, n_payload: int) -> int:
        return self.cfg.frame_samples((PHY_HEADER_BYTES_ + n_payload) * 8)

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        cfg = self.cfg
        if len(self._buf) < cfg.preamble_len + 1:
            return []
        out: list[Frame] = []
        consumed = 0
        # pad to power-of-2 buckets: bounded set of jit shapes
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
            bits = np.asarray(_demod_symbols_at(
                cfg, self.max_syms, pj, s))
            hdr = np.packbits(bits[:56])
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - 7:
                consumed = s + cfg.preamble_len
                continue
            total_bits = (7 + data_len) * 8
            frame_end = s + cfg.frame_samples(total_bits)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
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


PHY_HEADER_BYTES_ = 7


class OfdmModem:
    """Frame-level facade: PHY frames <-> OFDM waveform.

    With ``fec=True`` frame bits pass through Hamming(7,4) + a block
    interleaver sized to spread each codeword across subcarriers —
    single-bit-per-codeword errors (the dominant mode near the QPSK
    cliff) are corrected before the CRC sees them.
    """

    def __init__(self, cfg: OfdmConfig = OfdmConfig(),
                 fec: bool | str = False,
                 interleave_depth: int = 16):
        """fec: False | True/'hamming' (Hamming(7,4)+interleaver) |
        'conv' (rate-1/2 K=7 + soft-decision Viterbi)."""
        self.cfg = cfg
        self.fec = "hamming" if fec is True else (fec or None)
        assert self.fec in (None, "hamming", "conv")
        self.depth = interleave_depth

    def frame_bits(self, frame: Frame) -> np.ndarray:
        return bitops.bytes_to_bits_host(frame.to_bytes())

    def _tx_len(self, n_bits: int) -> int:
        if self.fec is None:
            return n_bits
        if self.fec == "conv":
            from trackmaker_tpu.core.convcode import K
            return 2 * (n_bits + K - 1)
        from trackmaker_tpu.core import fec
        c = fec.coded_len(n_bits)
        return -(-c // self.depth) * self.depth  # interleaver pad

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        assert frames
        n_bits = {len(f.to_bytes()) * 8 for f in frames}
        assert len(n_bits) == 1, "group equal-length frames"
        nb = n_bits.pop()
        bits = jnp.asarray(np.stack([self.frame_bits(f) for f in frames]))
        if self.fec == "hamming":
            from trackmaker_tpu.core import fec
            bits = fec.interleave(fec.hamming74_encode(bits), self.depth)
        elif self.fec == "conv":
            from trackmaker_tpu.core.convcode import conv_encode
            bits = jax.vmap(conv_encode)(bits)
        nb_tx = self._tx_len(nb)
        waves = np.asarray(modulate_bits(self.cfg, bits, nb_tx))
        parts = []
        for i, w in enumerate(waves):
            parts.append(w)
            if i < len(waves) - 1:
                parts.append(np.zeros(gap_samples, np.float32))
        return np.concatenate(parts)

    def decode(self, rx: np.ndarray, frame_bytes_len: int,
               max_frames: int = 64) -> list[Frame]:
        """Decode equal-length frames (frame_bytes_len = 7 + payload)."""
        n_bits = frame_bytes_len * 8
        n_tx = self._tx_len(n_bits)
        starts = np.asarray(find_preambles(
            self.cfg, jnp.asarray(rx), max_frames))
        starts = starts[starts >= 0]
        if len(starts) == 0:
            return []
        if self.fec == "conv":
            from trackmaker_tpu.core.convcode import viterbi_decode
            soft = demodulate_soft_at(
                self.cfg, jnp.asarray(rx), n_tx, jnp.asarray(starts))
            bits = jax.vmap(
                lambda s: viterbi_decode(s, n_bits, soft=True))(soft)
        else:
            bits = demodulate_at(
                self.cfg, jnp.asarray(rx), n_tx, jnp.asarray(starts))
            if self.fec == "hamming":
                from trackmaker_tpu.core import fec
                coded = fec.deinterleave(bits, self.depth,
                                         fec.coded_len(n_bits))
                bits = fec.hamming74_decode(coded)[..., :n_bits]
        bits = np.asarray(bits)
        out = []
        for row in bits:
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
