"""ASK/chirp modem as a batched device program (BASELINE config 1).

Reference: ``examples/ask.rs`` (itself a port of the course's
``docs/public/SamplePHY.m``): 10 kHz carrier ASK at 44 samples/bit
(~1090 bps), a 440-sample 2→10→2 kHz chirp preamble, an EMA power
detector, a sliding 440-tap chirp correlator with local-max peak picking,
and coherent demodulation (multiply-by-carrier + 11-tap smoothing +
per-bit integration over samples 10..30).

Batched design — same two-phase shape as the frame decoder:

* dense phase: EMA power is a first-order linear recurrence
  (``associative_scan``), the chirp correlator is one convolution, and the
  update predicate ``sync > max(2·power, 0.05)`` is elementwise;
* consumption phase: a ``lax.scan`` over frame slots replays the
  reference's local-max/200-sample-guard peak state machine *exactly* via
  a running-(max, first-index) associative scan over a bounded window,
  then demodulates a fixed 4752-sample window per detection (vectorized
  multiply/smooth/integrate).

The building blocks (dense arrays, warmup correlation, record chain,
first-update query, demod window) are module-level functions shared with
the speculative batched receiver in :mod:`trackmaker_tpu.phy.ask_spec`,
which replaces the sequential scan with a per-candidate successor table
plus a pointer-chase walk — op-for-op the same decisions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core import blockq
from trackmaker_tpu.dsp.filters import ema_power
from trackmaker_tpu.dsp.osc import carrier_np, chirp_cached


@dataclasses.dataclass(frozen=True)
class AskConfig:
    sample_rate: int = 48_000
    carrier_hz: float = 10_000.0
    samples_per_bit: int = 44
    frame_bits: int = 100          # 8-bit id + 92 payload bits
    crc_bits: int = 8              # placeholder zeros (ask.rs:611-613)
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    power_alpha: float = 1.0 / 64.0
    sync_divisor: float = 200.0
    sync_power_factor: float = 2.0    # sync > 2*power  (ask.rs:711)
    sync_abs_threshold: float = 0.05  # sync > 0.05
    peak_guard: int = 200             # fire 200 quiet samples after peak
    smooth_half: int = 5              # 11-tap box smoother
    bit_lo: int = 10                  # integrate smooth[10..30] per bit
    bit_hi: int = 30
    id_min: int = 1
    id_max: int = 100
    max_gap: int = 100                # random inter-frame gap upper bound

    @property
    def coded_bits(self) -> int:
        return self.frame_bits + self.crc_bits  # 108

    @property
    def frame_samples(self) -> int:
        return self.coded_bits * self.samples_per_bit  # 4752

    @property
    def payload_bits(self) -> int:
        return self.frame_bits - 8  # 92


class AskDecoded(NamedTuple):
    valid: jax.Array     # bool[K]
    frame_id: jax.Array  # int32[K]
    bits: jax.Array      # uint8[K, payload_bits]
    start: jax.Array     # int32[K]  fired peak index (reference start_index)

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)


def build_frames(text: bytes, cfg: AskConfig = AskConfig(),
                 num_frames: int = 100) -> np.ndarray:
    """Pack text into id+payload bit frames (ask.rs:545-569), with the
    reference's wrap quirk (reset cursor, then consume bit 0)."""
    text_bits = np.unpackbits(np.frombuffer(text, dtype=np.uint8))
    n_text = len(text_bits)
    payload = cfg.payload_bits
    frames = np.zeros((num_frames, cfg.frame_bits), dtype=np.uint8)
    ids = np.arange(1, num_frames + 1, dtype=np.uint32)
    frames[:, :8] = (ids[:, None] >> np.arange(7, -1, -1)) & 1
    idx = np.arange(num_frames * payload) % n_text
    frames[:, 8:] = text_bits[idx].reshape(num_frames, payload)
    return frames


@functools.partial(jax.jit, static_argnums=0)
def modulate_frames(cfg: AskConfig, frames: jax.Array) -> jax.Array:
    """uint8[B, frame_bits] -> f32[B, preamble+frame_samples]."""
    b = frames.shape[0]
    bits = jnp.concatenate(
        [frames.astype(jnp.float32),
         jnp.zeros((b, cfg.crc_bits), jnp.float32)], axis=-1)
    amp = 2.0 * bits - 1.0
    amp = jnp.repeat(amp, cfg.samples_per_bit, axis=-1)
    car = jnp.asarray(
        carrier_np(cfg.frame_samples, cfg.carrier_hz, cfg.sample_rate))
    wave = amp * car
    pre = jnp.asarray(chirp_cached(
        cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz, cfg.sample_rate))
    pre = jnp.broadcast_to(pre, (b, cfg.preamble_len))
    return jnp.concatenate([pre, wave], axis=-1)


def build_track(cfg: AskConfig, frames: np.ndarray,
                gaps: np.ndarray | None = None,
                seed: int = 1) -> np.ndarray:
    """Serialize modulated frames with random 0..max_gap silence before and
    after each frame (ask.rs:630-637)."""
    if gaps is None:
        rng = np.random.default_rng(seed)
        gaps = rng.integers(0, cfg.max_gap, size=(len(frames), 2))
    waves = np.asarray(modulate_frames(cfg, jnp.asarray(frames)))
    parts = []
    for i in range(len(frames)):
        parts.append(np.zeros(gaps[i, 0], np.float32))
        parts.append(waves[i])
        parts.append(np.zeros(gaps[i, 1], np.float32))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# Receiver building blocks — shared by the sequential scan receiver below
# and the speculative batched receiver (phy/ask_spec.py).  Any change to
# the decision ops here changes BOTH paths identically.
# ---------------------------------------------------------------------------


def _chirp_np(cfg: AskConfig) -> np.ndarray:
    return np.asarray(chirp_cached(
        cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz,
        cfg.sample_rate))


def dense_arrays(cfg: AskConfig, rx: jax.Array):
    """(power, sync, upd_ok) over the capture — the dense phase.

    `sync` is FIFO-aligned: lag i is the dot of the newest 440 samples
    ending AT sample i against the chirp, /200 (zero history at the
    start, matching the reference's zero-initialized FIFO)."""
    from trackmaker_tpu import sync as sync_mod
    power = ema_power(rx, cfg.power_alpha)
    sync = sync_mod.sliding_dot_scaled(
        rx, _chirp_np(cfg), 1.0 / cfg.sync_divisor)
    upd_ok = (sync > cfg.sync_power_factor * power) & (
        sync > cfg.sync_abs_threshold)
    return power, sync, upd_ok


@functools.lru_cache(maxsize=4)
def _warmup_band_np(cfg: AskConfig) -> np.ndarray:
    """Banded Toeplitz operator for the warmup correlations: the FIFO
    holds the newest p+1 samples at its TAIL, so
    out[p] = sum_{k<=p} slab[k] * pre[k + L-1-p]  <=>  slab @ W with
    W[k, p] = pre[k + L-1-p] for k <= p (one small matmul instead
    of 440 vmapped dynamic slices)."""
    pre_host = _chirp_np(cfg)
    l_pre = cfg.preamble_len
    w_np = np.zeros((l_pre, l_pre), np.float32)
    for p in range(l_pre):
        w_np[: p + 1, p] = pre_host[l_pre - 1 - p:]
    return w_np


def warmup_sync_at(cfg: AskConfig, rx_pad, power_pad, w_band, cursor, t):
    """Exact partial correlations for the L positions after a decode:
    the reference zeroes its sync FIFO when a frame fires
    (ask.rs:718-719), so sync at cursor+p only sees the p+1 samples
    received since.  Returns (sync_w[L], ok_w[L])."""
    l_pre = cfg.preamble_len
    slab = jax.lax.dynamic_slice(rx_pad, (cursor,), (l_pre,))
    out = jnp.matmul(slab, w_band,
                     precision=jax.lax.Precision.HIGHEST) \
        / cfg.sync_divisor                             # [L]
    pw = jax.lax.dynamic_slice(power_pad, (cursor,), (l_pre,))
    okw = (out > cfg.sync_power_factor * pw) & (
        out > cfg.sync_abs_threshold)
    pos_valid = cursor + jnp.arange(l_pre) < t
    return out, okw & pos_valid


def run_chain(cfg: AskConfig, sync_pad, upd_pad, chain_window,
              i0, cursor, sync_w, ok_w):
    """Local-max record chain + 200-sample fire guard, exactly
    (ask.rs:711-722), over a bounded window starting at i0.  Values in
    the 440-sample post-decode warmup region [cursor, cursor+L) are
    substituted from (sync_w, ok_w).  Returns (peak, fired).

    The warmup overlap is a contiguous PREFIX of the window (i0 >=
    cursor always), so the substitution is a dynamic_slice of the
    padded warmup arrays + an elementwise select, not an index-math
    ``sync_w[woff_c]`` with per-candidate indices (which lowers under
    the double vmap to a per-element gather)."""
    l_pre = cfg.preamble_len
    idx = i0 + jnp.arange(chain_window, dtype=jnp.int32)
    sp = jax.lax.dynamic_slice(sync_pad, (i0,), (chain_window,))
    ok = jax.lax.dynamic_slice(upd_pad, (i0,), (chain_window,))
    off = jnp.arange(chain_window, dtype=jnp.int32)
    woff0 = jnp.clip(i0 - cursor, 0, l_pre)       # window offset 0 -> woff0
    sw_pad = jnp.concatenate(
        [sync_w, jnp.full(chain_window + 8, -jnp.inf, sync_w.dtype)])
    okw_pad = jnp.concatenate(
        [ok_w, jnp.zeros(chain_window + 8, bool)])
    sw = jax.lax.dynamic_slice(sw_pad, (woff0,), (chain_window,))
    okw = jax.lax.dynamic_slice(okw_pad, (woff0,), (chain_window,))
    in_warm = off < (l_pre - woff0)               # prefix of the window
    sp = jnp.where(in_warm, sw, sp)
    ok = jnp.where(in_warm, okw, ok)
    vals = jnp.where(ok, sp, -jnp.inf)

    def combine(a, b):
        av, ai = a
        bv, bi = b
        take_b = bv > av        # strict: earlier index wins ties
        return jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai)

    m_incl, rec_incl = jax.lax.associative_scan(
        combine, (vals, idx), axis=-1)
    m_excl = jnp.concatenate([jnp.asarray([-jnp.inf]), m_incl[:-1]])
    rec_excl = jnp.concatenate([idx[:1], rec_incl[:-1]])
    upd_now = ok & (sp > m_excl)
    fire = (~upd_now) & (idx > rec_excl + cfg.peak_guard) & (
        m_excl > -jnp.inf)
    j = jnp.argmax(fire)            # first fire
    fired = fire[j]
    peak = jnp.where(fired, rec_excl[j], rec_incl[-1])
    return peak, fired


# Two-level block index for "first update >= cursor" queries — shared
# generic implementation in core/blockq.py (instead of a global nonzero
# compaction).
upd_block_tables = blockq.block_tables
first_upd_from = blockq.first_set_from


@functools.lru_cache(maxsize=4)
def _demod_weights_np(cfg: AskConfig) -> np.ndarray:
    """f32[frame_samples, coded_bits] weight matrix folding the 11-tap
    edge-truncated box smooth (ask.rs:418-432) AND the per-bit
    integration over smooth[bit_lo..bit_hi) (ask.rs:433-443) into ONE
    linear operator on the carrier product:

        sums[i] = sum_p in bit-i window  mean(prod[p-h .. p+h])
                = prod @ W[:, i]

    Both stages are linear, so the composition is exact up to f32
    summation order.  As a matmul the whole post-pass is one product
    per slot instead of a conv + a doubly-vmapped ``smooth[bit_idx]``
    fancy gather."""
    n = cfg.frame_samples
    h = cfg.smooth_half
    w = np.zeros((n, cfg.coded_bits), np.float32)
    for i in range(cfg.coded_bits):
        for p in range(cfg.bit_lo + i * cfg.samples_per_bit,
                       cfg.bit_hi + i * cfg.samples_per_bit):
            j0, j1 = max(0, p - h), min(n, p + h + 1)
            w[j0:j1, i] += np.float32(1.0) / np.float32(j1 - j0)
    return w


def demod_tables(cfg: AskConfig):
    """(carrier, fused smooth+integrate weights) for the demod window."""
    car = jnp.asarray(
        carrier_np(cfg.frame_samples, cfg.carrier_hz, cfg.sample_rate))
    return car, jnp.asarray(_demod_weights_np(cfg))


def _demod_decisions(cfg: AskConfig, bits, peak, ok):
    """Shared demod epilogue: the 1..100 frame-id filter + output dict
    (ask.rs:755-767)."""
    fid = jnp.sum(
        bits[:8].astype(jnp.int32) *
        (1 << jnp.arange(7, -1, -1)), axis=-1)
    id_ok = (fid >= cfg.id_min) & (fid <= cfg.id_max)
    valid = ok & id_ok
    return dict(
        valid=valid,
        frame_id=jnp.where(valid, fid, 0),
        bits=jnp.where(valid, bits[8:cfg.frame_bits],
                       0).astype(jnp.uint8),
        start=jnp.where(valid, peak, -1),
    )


def demod_slot(cfg: AskConfig, rx_pad, car, weights, peak, ok):
    """Coherent demod of the 4752-sample window after a fired peak
    (ask.rs:723-767): multiply-by-carrier, then the fused
    smooth+integrate weight matmul, then the 1..100 frame-id filter."""
    win = jax.lax.dynamic_slice(
        rx_pad, (jnp.clip(peak + 1, 0),), (cfg.frame_samples,))
    sums = jnp.dot(win * car, weights,
                   precision=jax.lax.Precision.HIGHEST)  # (coded_bits,)
    return _demod_decisions(cfg, sums > 0.0, peak, ok)


@functools.lru_cache(maxsize=4)
def _demod_dense_tables_np(cfg: AskConfig):
    """Tables for the DENSE demod decomposition, or None when the
    config's geometry doesn't admit it.

    The carrier is periodic (10 kHz at 48 kHz = exactly 24 samples), so
    the window product splits over the window start p0:

        win[i]*car[i] = rx[p0+i]*sin(w(j-p0))         (j = p0+i)
                      = cos(w p0)*rx[j]sin(wj) - sin(w p0)*rx[j]cos(wj)

    and — because with the default geometry the 11-tap edge-truncated
    smooth never actually truncates (bit_lo >= h and bit_hi + h <=
    samples_per_bit) — every per-bit smooth+integrate column of
    `_demod_weights_np` is ONE shared 30-tap kernel K = ones(nint) *
    ones(nsm)/nsm placed at bit_lo - h + c*spb.  So the whole post-pass
    reduces to two dense 30-tap sliding dots plus a per-slot strided
    108-element pick — no per-slot 4752-sample gather, no [4752, 108]
    matmul (the doubly-vmapped window slice lowers to per-element
    gathers)."""
    import math
    fhz = cfg.carrier_hz
    if abs(fhz - round(fhz)) > 1e-9:
        return None
    if cfg.bit_lo < cfg.smooth_half or (
            cfg.bit_hi + cfg.smooth_half > cfg.samples_per_bit):
        return None                      # edge truncation would fire
    g = math.gcd(int(round(fhz)), cfg.sample_rate)
    period = cfg.sample_rate // g
    if period > 4096:
        return None
    nsm = 2 * cfg.smooth_half + 1
    k = np.convolve(
        np.ones(cfg.bit_hi - cfg.bit_lo, np.float64),
        np.ones(nsm, np.float64) / nsm).astype(np.float32)
    ph = (2.0 * np.pi * (int(round(fhz)) // g)
          * np.arange(period, dtype=np.float64) / period)
    return (k, np.sin(ph).astype(np.float32),
            np.cos(ph).astype(np.float32))


def demod_dense(cfg: AskConfig, rx: jax.Array):
    """Dense demod arrays (ds, dc) for one capture: the bit sums of a
    window starting at p0 are

        sums[c] = cos[p0 % P]*ds[q] - sin[p0 % P]*dc[q],
        q = p0 + bit_lo - smooth_half + c*samples_per_bit

    (see `_demod_dense_tables_np`).  Both arrays cover q in
    [0, T + frame_samples) so any complete window's picks are
    in-bounds."""
    k, s_per, c_per = _demod_dense_tables_np(cfg)
    t = rx.shape[-1]
    period = s_per.shape[0]
    reps = -(-t // period)
    sw = jnp.tile(jnp.asarray(s_per), reps)[:t]
    cw = jnp.tile(jnp.asarray(c_per), reps)[:t]
    from trackmaker_tpu import sync as sync_mod
    l = len(k)
    pad = cfg.frame_samples + l
    xs = jnp.concatenate([rx * sw, jnp.zeros(pad, jnp.float32)])
    xc = jnp.concatenate([rx * cw, jnp.zeros(pad, jnp.float32)])
    ds = sync_mod.sliding_dot_scaled(xs, k, 1.0)[l - 1:]
    dc = sync_mod.sliding_dot_scaled(xc, k, 1.0)[l - 1:]
    return ds, dc


def demod_slot_dense(cfg: AskConfig, ds, dc, s_per, c_per, peak, ok):
    """Per-slot demod from the dense arrays: a strided coded_bits-element
    pick + the 2-term carrier-phase combination.  Decision-equivalent to
    `demod_slot` (same real-arithmetic sums, f32 rounding aside) —
    pinned by tests/test_ask_spec.py::test_dense_demod_matches_slot."""
    p0 = jnp.clip(peak + 1, 0)
    m = jnp.mod(p0, s_per.shape[0])
    q0 = p0 + cfg.bit_lo - cfg.smooth_half
    idx = q0 + cfg.samples_per_bit * jnp.arange(
        cfg.coded_bits, dtype=jnp.int32)
    sums = c_per[m] * ds[idx] - s_per[m] * dc[idx]
    return _demod_decisions(cfg, sums > 0.0, peak, ok)


def demod_slots_dense(cfg: AskConfig, ds, dc, s_per, c_per, peaks, oks):
    """All slots of one capture from the dense arrays at once, the
    strided picks restructured as row-gathers.

    ``ds`` reshaped to [n, samples_per_bit] rows makes a slot's picks
    ``ds[q0 + spb*c]`` a CONTIGUOUS run of coded_bits rows at the single
    column ``q0 % spb`` (row ``q0//spb + c`` for bit c).  Rows group
    into 8-row SUPER-rows — 3.6x fewer, 352-element fetches than one
    row at a time — and the residual (row realign, column pick) is one
    fused double-one-hot einsum: exactly one 1.0 per (row, column)
    pair, so the pick is exact at HIGHEST precision.  Picked values are
    bit-identical
    to :func:`demod_slot_dense` (pinned by
    tests/test_ask_spec.py::test_demod_slots_dense_matches_slot)."""
    spb = cfg.samples_per_bit
    cb = cfg.coded_bits
    g = 8                                  # bit-rows per super-row
    nsup_need = cb // g + 2
    k = peaks.shape[0]
    p0 = jnp.clip(peaks + 1, 0)
    m = jnp.mod(p0, s_per.shape[0])
    q0 = p0 + cfg.bit_lo - cfg.smooth_half
    r0 = q0 // spb
    col = q0 % spb
    nr = ds.shape[-1] // spb + cb + 2 * g
    nsup = -(-nr // g)

    def mk(d):
        pad = nsup * g * spb - d.shape[-1]
        return jnp.pad(d, (0, pad)).reshape(nsup, g * spb)

    dsr, dcr = mk(ds), mk(dc)
    s0 = r0 // g
    sup = s0[:, None] + jnp.arange(nsup_need, dtype=jnp.int32)
    slab_s = jnp.take(dsr, sup, axis=0).reshape(k, nsup_need * g, spb)
    slab_c = jnp.take(dcr, sup, axis=0).reshape(k, nsup_need * g, spb)
    ro = r0 - s0 * g                       # residual rows, in [0, g)
    ri = jnp.arange(cb, dtype=jnp.int32)[None, :, None]
    rj = jnp.arange(nsup_need * g, dtype=jnp.int32)[None, None, :]
    selr = (rj == ri + ro[:, None, None]).astype(jnp.float32)
    onec = (jnp.arange(spb, dtype=jnp.int32)[None, :]
            == col[:, None]).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    picks_s = jnp.einsum("kcr,krs,ks->kc", selr, slab_s, onec,
                         precision=hi)
    picks_c = jnp.einsum("kcr,krs,ks->kc", selr, slab_c, onec,
                         precision=hi)
    sums = (c_per[m][:, None] * picks_s - s_per[m][:, None] * picks_c)
    return jax.vmap(
        lambda b, p, o: _demod_decisions(cfg, b, p, o)
    )(sums > 0.0, peaks, oks)


@functools.partial(
    jax.jit, static_argnames=("cfg", "max_frames", "chain_window"))
def demodulate(
    cfg: AskConfig,
    rx: jax.Array,                  # f32[T]
    max_frames: int = 128,
    chain_window: int = 4096,
) -> AskDecoded:
    """Batched receiver replaying ask.rs:693-796 decision-for-decision."""
    rx = rx.astype(jnp.float32)
    t = rx.shape[-1]

    # dense phase ------------------------------------------------------
    power, sync, upd_ok = dense_arrays(cfg, rx)
    upd_tables = upd_block_tables(upd_ok)

    l_pre = cfg.preamble_len
    pad = cfg.frame_samples + chain_window + 8
    rx_pad = jnp.concatenate([rx, jnp.zeros(pad, jnp.float32)])
    sync_pad = jnp.concatenate(
        [sync, jnp.full(chain_window + 8, -jnp.inf, jnp.float32)])
    upd_pad = jnp.concatenate(
        [upd_ok, jnp.zeros(chain_window + 8, bool)])
    power_pad = jnp.concatenate([power, jnp.zeros(l_pre + 8, jnp.float32)])
    w_band = jnp.asarray(_warmup_band_np(cfg))
    car, wts = demod_tables(cfg)

    def step(carry, _):
        cursor, done = carry
        # first update position: exact warmup sync inside
        # [cursor, cursor+L), dense sync beyond
        sync_w, ok_w = warmup_sync_at(
            cfg, rx_pad, power_pad, w_band, cursor, t)
        warm_idx = cursor + jnp.arange(l_pre, dtype=jnp.int32)
        first_warm = jnp.min(jnp.where(ok_w, warm_idx, 2**30))
        first_dense, has_dense = first_upd_from(upd_tables, cursor + l_pre)
        first_dense = jnp.where(has_dense, first_dense, 2**30)
        first = jnp.minimum(first_warm, first_dense)
        has = (first < 2**30) & ~done
        i0 = jnp.clip(first, 0, t - 1)

        peak, fired = run_chain(cfg, sync_pad, upd_pad, chain_window,
                                i0, cursor, sync_w, ok_w)
        ok_fire = has & fired

        # frame complete only if the decode window fits in the capture:
        # the reference's fifo fills at absolute index peak + frame_samples
        complete = (peak + cfg.frame_samples) < t

        # NOTE: the cursor advance depends only on (peak, fired,
        # complete) — never on the demodulated bits (the reference
        # advances past id-filtered frames identically, ask.rs:723-767)
        # — so the expensive per-frame demod runs OUTSIDE the scan,
        # vmapped over all slots at once.
        new_cursor = jnp.where(
            ok_fire & complete, peak + cfg.frame_samples + 1, cursor)
        new_done = done | ~has | (ok_fire & ~complete) | ~fired
        out = dict(
            fire_ok=ok_fire & complete,
            peak=peak,
        )
        return (new_cursor, new_done), out

    (_, _), ys = jax.lax.scan(
        step, (jnp.int32(0), jnp.asarray(False)), None, length=max_frames,
        # per-step work is tiny; unrolling amortizes the while-loop
        # per-iteration overhead exactly as in phy/decoder.py
        unroll=min(8, max_frames))

    # ---- post-pass: demodulate all fired slots at once -----------------
    return AskDecoded(**jax.vmap(
        lambda pk, ok: demod_slot(cfg, rx_pad, car, wts, pk, ok))(
            ys["peak"], ys["fire_ok"]))


def demodulate_fast(cfg: AskConfig, rx, max_frames: int = 128):
    """Host-level ASK demod through the fastest sound receiver.

    Runs the speculative batched receiver (phy/ask_spec.py) and
    re-decodes any capture whose conformance flags fired (fired peak
    outside the dense candidate table, chain not resolved inside the
    bounded window, or candidate overflow) with the exact scan receiver.
    Accepts f32[T] or f32[B, T]."""
    from trackmaker_tpu.phy import ask_spec
    x = jnp.asarray(rx, jnp.float32)
    batched = x.ndim == 2
    xb = x if batched else x[None]
    res, ok = ask_spec.demodulate_spec_jit(cfg, xb, max_frames=max_frames)
    ok = np.asarray(ok)
    if not ok.all():
        # re-decode only the flagged rows, one scan each
        res = AskDecoded(*[np.array(a) for a in res])
        for b in np.nonzero(~ok)[0]:
            exact = demodulate(cfg, xb[b], max_frames=max_frames)
            for dst, src in zip(res, exact):
                dst[b] = np.asarray(src)
    return res if batched else jax.tree_util.tree_map(lambda a: a[0], res)


def assemble_text(decoded: AskDecoded) -> bytes:
    """Concatenate payload bits of valid frames in arrival order and pack
    to bytes (ask.rs:773-788)."""
    valid = np.asarray(decoded.valid)
    bits = np.asarray(decoded.bits)[valid].reshape(-1)
    n = (len(bits) // 8) * 8
    return np.packbits(bits[:n]).tobytes()
