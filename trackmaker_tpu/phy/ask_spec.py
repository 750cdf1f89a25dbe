"""Speculative batched ASK receiver: dense fire-candidates + successor
table + pointer-chase walk.

The exact scan receiver (phy/ask.py:demodulate) replays the reference's
record-chain state machine (examples/ask.rs:693-796) one frame slot per
`lax.scan` step, each step a chain of ~100 small dependent ops.  This
module restructures it the same way phy/spec_decode.py restructured the
frame decoder:

1. *Dense candidates*: position r can be a fired peak iff ``upd_ok[r]``
   and no strictly-better update exists in ``(r, r+guard+1]``.  This
   exactly characterizes the record-chain fire rule: a record r is
   displaced only by an update with sync strictly above it arriving
   before the fire check at r+guard+1 (ask.rs:711-722 — the `elif`
   orders update before fire, so the displacement window is guard+1
   wide).  Computed densely with a two-pass sliding-window max and
   extracted via the same block-peel used by the frame decoder.

2. *Successor table* (phase B): for every candidate c — treated as "a
   frame just decoded with peak c" — replay the exact per-step logic
   (warmup-corrected FIFO restart at cursor c + frame + 1, first-update
   query, bounded record chain) vmapped over ALL candidates at once,
   yielding (has, fired, complete, next_peak).  `next_peak` is mapped
   back to a candidate index: in the dense region a fired peak is
   always a dense candidate (its displacement window is past the
   440-sample warmup region, so the dense rule applies verbatim); a
   peak inside the warmup region is not in the table and conformance-
   flags the capture for exact re-decode.

3. *Walk*: the sequential frame loop becomes pointer-chasing over the
   successor table — a `max_frames`-step loop of integer gathers
   instead of the scan's full receiver step.  Slot k of the walk
   corresponds exactly to scan step k, so results are equal
   slot-for-slot.

The demod post-pass (multiply/smooth/integrate per fired window) is
shared with the scan receiver and already vmapped.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.phy import ask
from trackmaker_tpu.phy.ask import AskConfig, AskDecoded

_BIGI = np.int32(2**30)

def dense_fire_candidates(cfg: AskConfig, sync: jax.Array,
                          upd_ok: jax.Array):
    """bool[T] mask of positions that fire if they become the chain
    record: upd_ok[r] with no strictly-greater masked sync in
    (r, r+guard+1] (window arithmetic per the module docstring).

    Sliding max on 128-aligned blocks.  With B=128 blocks the
    window [i, i+w-1] spans 2..3 blocks (w in (B, 2B+1]), so
    max = suf[i] ∨ (middle block maxima) ∨ pre[i+w-1], where pre/suf
    are lane-aligned per-block cummaxes and every other term is a
    STATIC shift (slice) — max is exact, so decisions are unchanged."""
    t = sync.shape[-1]
    w = cfg.peak_guard + 1                      # 201
    bsz = 128
    masked = jnp.where(upd_ok, sync, -jnp.inf)
    if w <= bsz:                                 # exotic config: van Herk
        nb = -(-(t + w) // w) + 1
        mp = jnp.pad(masked, (0, nb * w - t), constant_values=-jnp.inf)
        blocks = mp.reshape(nb, w)
        pre = jax.lax.cummax(blocks, axis=1).reshape(-1)
        suf = jnp.flip(jax.lax.cummax(jnp.flip(blocks, 1), axis=1),
                       1).reshape(-1)
        swin = jnp.maximum(suf[:t + 1], pre[w - 1: t + w])
        fwd_max = swin[1: t + 1]
        return upd_ok & (masked[:t] >= fwd_max)
    if w > 2 * bsz:                              # exotic config: 1-D form
        nb = (t + w) // bsz + 2
        mp = jnp.pad(masked, (0, nb * bsz - t), constant_values=-jnp.inf)
        blocks = mp.reshape(nb, bsz)
        pre = jax.lax.cummax(blocks, axis=1).reshape(-1)
        suf = jnp.flip(jax.lax.cummax(jnp.flip(blocks, 1), axis=1),
                       1).reshape(-1)
        bm = jnp.max(blocks, axis=1)
        rep_bm = jnp.repeat(bm, bsz)
        n = t + 1
        off = jnp.arange(n, dtype=jnp.int32) % bsz
        swin = jnp.maximum(suf[:n], pre[w - 1: w - 1 + n])
        n_mid = (w - 2) // bsz
        for mi in range(n_mid):
            mid = rep_bm[(mi + 1) * bsz: (mi + 1) * bsz + n]
            swin = jnp.maximum(
                swin,
                jnp.where(off >= (mi + 2) * bsz - w + 1, mid, -jnp.inf))
        fwd_max = swin[1: t + 1]
        return upd_ok & (masked[:t] >= fwd_max)
    # fully 2-D form, no misaligned 1-D slices: for position
    # i = q*B + r the window is (i, i+w],
    # and with B < w <= 2B every term is a static row/lane split:
    #   suffix of i+1's block:  r<B-1 -> suf2[q, r+1];  r=B-1 -> suf2[q+1, 0]
    #   prefix at i+w:          r<2B-w -> pre2[q+1, r+w-B]; else pre2[q+2, r+w-2B]
    #   middle block max:       bm[q+1], exactly when r in [2B-w, B-1)
    nb = (t + w) // bsz + 4
    mp = jnp.pad(masked, (0, nb * bsz - t), constant_values=-jnp.inf)
    blocks = mp.reshape(nb, bsz)
    pre2 = jax.lax.cummax(blocks, axis=1)
    suf2 = jnp.flip(jax.lax.cummax(jnp.flip(blocks, 1), axis=1), 1)
    bm = jnp.max(blocks, axis=1)
    nq = nb - 2                                   # rows covering [0, t)
    split = 2 * bsz - w                           # 55 for w=201
    t1 = jnp.concatenate([suf2[:nq, 1:], suf2[1:nq + 1, :1]], axis=1)
    t2 = jnp.concatenate([pre2[1:nq + 1, w - bsz:],
                          pre2[2:nq + 2, :w - bsz]], axis=1)
    lane = jnp.arange(bsz, dtype=jnp.int32)[None, :]
    t3 = jnp.where((lane >= split) & (lane < bsz - 1),
                   bm[1:nq + 1][:, None], -jnp.inf)
    fwd2 = jnp.maximum(jnp.maximum(t1, t2), t3)
    hit2 = blocks[:nq] >= fwd2
    return upd_ok & hit2.reshape(-1)[:t]


_R = 512  # fetch-row width for aligned window gathers


# out[c, k] = src[c, k + s[c]] exactly, with only a small one-hot
# materialized (8-way static-shift select + one-hot row matmul —
# core/realign.py; out-of-range shifts incl. the sentinel cursors
# yield zeros, exactly where the consumers mask)
from trackmaker_tpu.core.realign import shift_realign as _shift_realign  # noqa: E402


def _resolve_chain(vals: jax.Array, idx: jax.Array, guard: int):
    """(fired[C], peak[C]) of the record chain along each row of `vals`
    (-inf = masked): a running (max, record) pair scan with the
    earliest index winning ties; a position fires when it is not an
    update and lies more than `guard` samples past the current record
    (ask.rs:711-722).  `peak` is the first fire's record, else the final
    record."""
    win = vals.shape[-1]

    def combine(a, b):
        av, ai = a
        bv, bi = b
        take_b = bv > av    # strict: earlier index wins ties
        return jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai)

    m_incl, rec_incl = jax.lax.associative_scan(
        combine, (vals, idx), axis=-1)
    m_excl = jnp.concatenate(
        [jnp.full(vals.shape[:-1] + (1,), -jnp.inf), m_incl[..., :-1]],
        axis=-1)
    rec_excl = jnp.concatenate([idx[..., :1], rec_incl[..., :-1]], axis=-1)
    upd_now = vals > m_excl
    fire = (~upd_now) & (idx > rec_excl + guard) & (m_excl > -jnp.inf)
    # first-fire pick: one-hot on the first True of `fire` (all-False
    # rows -> zero one-hot -> fired False, peak falls back to the final
    # record)
    wrng = jnp.arange(win, dtype=jnp.int32)
    j1 = jnp.min(jnp.where(fire, wrng, win), axis=-1, keepdims=True)
    fired = jnp.any(fire, axis=-1)
    peak = jnp.where(fired,
                     jnp.sum(jnp.where(wrng == j1, rec_excl, 0), axis=-1),
                     rec_incl[..., -1])
    return fired, peak


def _phase_b(cfg: AskConfig, rx, power, sync, upd_ok, cand_full,
             chain_window: int):
    """Per-candidate successor fields for one capture.

    cand_full: i32[C+1], ascending; slot 0 is the virtual stream-start
    candidate at -(frame_samples+1) so its cursor is exactly 0 (the
    reference's initial zeroed-FIFO state).  Returns i32[5, C+1] rows
    has/fired/complete/next_peak/succ_idx.

    Every window is fetched on 512-aligned rows via ``jnp.take``
    (whole-row gathers); the chain runs on the wider
    [row_start, row_start + CW + 512) window with the pre-``i0``
    prefix masked off (masked entries have ok=False → -inf, so they
    cannot create records or fires — decisions are unchanged, and the
    ≥CW effective window can only *resolve* chains the old fixed-CW
    window conformance-flagged; any fire inside a prefix window fires
    identically in the scan receiver's 4096 window).  Only the
    440-wide warmup band is realigned exactly, via one-hot f32
    row-selection matmuls (each output has exactly one 1.0 multiplier
    — exact at HIGHEST precision)."""
    t = rx.shape[-1]
    l_pre = cfg.preamble_len
    c1 = cand_full.shape[0]
    upd_tables = ask.upd_block_tables(upd_ok)
    win = chain_window + _R
    assert win % _R == 0, "chain_window must be a multiple of 512"
    rows_n = win // _R

    # rx_pad is only returned for the (env-gated) per-slot demod path
    rx_pad = jnp.concatenate(
        [rx, jnp.zeros(cfg.frame_samples + chain_window + 8, jnp.float32)])

    def as_rows(a, fill, need_rows):
        nr = (t - 1) // _R + need_rows + 2
        pad = nr * _R - t
        return jnp.pad(a, (0, pad), constant_values=fill).reshape(nr, _R), nr

    s_rows, nr_s = as_rows(sync, -jnp.inf, rows_n)
    u_rows, _ = as_rows(upd_ok, False, rows_n)
    r_rows, nr_r = as_rows(rx, 0.0, 2)
    p_rows, _ = as_rows(power, 0.0, 2)
    w_band = jnp.asarray(ask._warmup_band_np(cfg))

    cursor = jnp.minimum(cand_full + cfg.frame_samples + 1, _BIGI)

    # --- warmup correlations (exact FIFO-restart partials) ----------
    # slab/power at [cursor, cursor+440) from two aligned rows, then a
    # one-hot realign matmul; a padded/BIGI cursor yields an all-zero
    # one-hot -> zero slab -> ok_w all-False (abs threshold), exactly
    # like the old out-of-range dynamic_slice reads of the zero pad.
    rb = jnp.clip(cursor // _R, 0, nr_r - 2)
    two = jnp.arange(2, dtype=jnp.int32)
    rw = jnp.take(r_rows, rb[:, None] + two, axis=0).reshape(c1, 2 * _R)
    pw2 = jnp.take(p_rows, rb[:, None] + two, axis=0).reshape(c1, 2 * _R)
    o1 = cursor - rb * _R
    pad8 = (-l_pre) % 8
    slab = _shift_realign(rw, o1, l_pre + pad8)[:, :l_pre]
    pw_p = _shift_realign(pw2, o1, l_pre + pad8)[:, :l_pre]
    sync_w = jnp.matmul(slab, w_band,
                        precision=jax.lax.Precision.HIGHEST) \
        / cfg.sync_divisor                               # [C, l_pre]
    parng = jnp.arange(l_pre, dtype=jnp.int32)[None, :]
    pos_valid = cursor[:, None] + parng < t
    ok_w = ((sync_w > cfg.sync_power_factor * pw_p)
            & (sync_w > cfg.sync_abs_threshold) & pos_valid)

    first_warm = jnp.min(
        jnp.where(ok_w, cursor[:, None] + parng, _BIGI), axis=-1)
    first_dense, has_dense = jax.vmap(
        lambda c: ask.first_upd_from(upd_tables, c))(cursor + l_pre)
    first = jnp.minimum(first_warm,
                        jnp.where(has_dense, first_dense, _BIGI))
    has = first < _BIGI
    i0 = jnp.clip(first, 0, t - 1)

    # --- aligned chain windows with masked prefix --------------------
    wb = jnp.clip(i0 // _R, 0, nr_s - rows_n)
    rrng = jnp.arange(rows_n, dtype=jnp.int32)
    sp_w = jnp.take(s_rows, wb[:, None] + rrng, axis=0).reshape(c1, win)
    ok_wn = jnp.take(u_rows, wb[:, None] + rrng, axis=0).reshape(c1, win)
    base_w = wb * _R
    idx = base_w[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]

    # warmup substitution: the warm band starts at window offset
    # cursor - base_w <= 511 (base_w >= i0-511 >= cursor-511), so only
    # the first l_pre + 512 window columns can ever be warm.  The
    # realign sw_sub[j] = sync_w[j - sh] runs through _shift_realign
    # on a 512-offset source (s = 512 - sh >= 1 whenever the band
    # touches the window; out-of-range shifts -> zeros, and in_warm is
    # False exactly there)
    wsub = l_pre + _R
    l2 = 3008                   # covers j + s for every in-use shift
    zpad = jnp.zeros((c1, _R), jnp.float32)
    src_s = jnp.concatenate(
        [zpad, sync_w, jnp.zeros((c1, l2 - _R - l_pre), jnp.float32)],
        axis=-1)
    src_o = jnp.concatenate(
        [zpad, ok_w.astype(jnp.float32),
         jnp.zeros((c1, l2 - _R - l_pre), jnp.float32)], axis=-1)
    s2 = _R - (cursor - base_w)
    sw_sub = _shift_realign(src_s, s2, wsub)
    okw_sub = _shift_realign(src_o, s2, wsub) > 0.5
    in_warm = ((idx[:, :wsub] >= cursor[:, None])
               & (idx[:, :wsub] < cursor[:, None] + l_pre))
    sp_full = jnp.concatenate(
        [jnp.where(in_warm, sw_sub, sp_w[:, :wsub]), sp_w[:, wsub:]],
        axis=-1)
    ok_full = jnp.concatenate(
        [jnp.where(in_warm, okw_sub, ok_wn[:, :wsub]), ok_wn[:, wsub:]],
        axis=-1)

    ok_m = ok_full & (idx >= i0[:, None])
    vals = jnp.where(ok_m, sp_full, -jnp.inf)

    fired, peak = _resolve_chain(vals, idx, cfg.peak_guard)
    complete = (peak + cfg.frame_samples) < t

    # next_peak -> candidate index (the successor); -1 when the fired
    # peak is not a dense candidate (warmup-region fire) — conformance
    succ = jnp.searchsorted(cand_full, peak).astype(jnp.int32)
    c1 = cand_full.shape[0]
    found = (succ < c1) & (cand_full[jnp.clip(succ, 0, c1 - 1)] == peak)
    succ = jnp.where(found, succ, -1)
    # has & ~fired can mean EITHER stream-end-without-fire (scan: done)
    # OR a chain truncated by the bounded window (the 4096-window scan
    # might still fire) — conformance-flag it so visited occurrences
    # fall back to the exact receiver instead of silently stopping
    nc = has & ~fired
    return jnp.stack([has.astype(jnp.int32), fired.astype(jnp.int32),
                      complete.astype(jnp.int32), peak, succ,
                      nc.astype(jnp.int32)]), rx_pad


def _walk(fields, max_frames: int):
    """Pointer chase over the successor table, all captures at once.
    fields rows: 0=has, 1=fired, 2=complete, 3=next_peak, 4=succ_idx,
    5=nonconf.  Returns (peak per slot, fire_ok&complete per slot, bad
    = the walk visited a candidate the table cannot represent
    exactly)."""
    b = fields.shape[0]

    def body(k, carry):
        i, done, bad, peaks, oks = carry
        row = jnp.take_along_axis(fields, i[:, None, None], axis=2)[..., 0]
        has, fired, complete, peak, succ, nc = (row[:, j] for j in range(6))
        active = ~done
        ok_fire = active & (has > 0) & (fired > 0)
        emit = ok_fire & (complete > 0)
        miss = (emit & (succ < 0)) | (active & (nc > 0))
        done = done | (active & ((has == 0) | (fired == 0)
                                 | (ok_fire & (complete == 0)) | miss))
        peaks = peaks.at[:, k].set(peak)
        oks = oks.at[:, k].set(emit)
        return (jnp.where(emit & (succ >= 0), succ, i), done, bad | miss,
                peaks, oks)

    init = (jnp.zeros(b, jnp.int32), jnp.zeros(b, bool), jnp.zeros(b, bool),
            jnp.zeros((b, max_frames), jnp.int32),
            jnp.zeros((b, max_frames), bool))
    _i, _done, bad, peaks, fire_ok = jax.lax.fori_loop(
        0, max_frames, body, init)
    return peaks, fire_ok, bad


def demodulate_spec(
    cfg: AskConfig,
    rx: jax.Array,                 # f32[B, T]
    max_frames: int = 128,
    n_cand: int = 96,
    chain_window: int = 512,     # must be a multiple of _R; 512 stays
    #                              conformant with decisions equal to
    #                              1024 on every probed track, and the
    #                              chain arrays are phase_b's bulk
):
    """Batched speculative ASK demod.  Returns ``(AskDecoded[B, K],
    ok[B])``; rows with ``ok=False`` (candidate-table overflow, a
    warmup-region fire the successor table cannot represent, or a chain
    unresolved inside `chain_window`) must be re-decoded with the exact
    scan receiver — :func:`trackmaker_tpu.phy.ask.demodulate_fast` does
    this automatically.  On conformant rows results equal the scan
    receiver slot-for-slot (a chain that fires inside the smaller
    window fires identically in the scan's 4096 window: the window
    values are a prefix).

    ``TM_ASK_DENSE=0`` (read at trace time — set before process start)
    falls back from the dense demod post-pass to the per-slot window
    demod."""
    from trackmaker_tpu.phy.spec_decode import _extract_candidates
    rx = jnp.asarray(rx, jnp.float32)
    assert rx.ndim == 2
    b, t = rx.shape

    def analyze(row):
        power, sync, upd_ok = ask.dense_arrays(cfg, row)
        hits = dense_fire_candidates(cfg, sync, upd_ok)
        cand, _nv, overflow = _extract_candidates(
            hits, n_cand, rpb=8)
        virt = jnp.full((1,), -(cfg.frame_samples + 1), jnp.int32)
        cand_full = jnp.concatenate([virt, cand])
        fields, rx_pad = _phase_b(cfg, row, power, sync, upd_ok,
                                  cand_full, chain_window)
        return fields, rx_pad, overflow

    fields, rx_pads, overflow = jax.vmap(analyze)(rx)
    peaks, fire_ok, bad = _walk(fields, max_frames)

    import os
    if (ask._demod_dense_tables_np(cfg) is not None
            and os.environ.get("TM_ASK_DENSE", "1") != "0"):
        # dense demod: two 30-tap sliding dots per capture + a strided
        # pick per slot, replacing the doubly-vmapped 4752-sample window
        # gather + [4752, 108] matmul (ask.py:demod_dense)
        _k, s_per, c_per = ask._demod_dense_tables_np(cfg)
        s_per = jnp.asarray(s_per)
        c_per = jnp.asarray(c_per)
        ds, dc = jax.vmap(lambda row: ask.demod_dense(cfg, row))(rx)
        res = jax.vmap(lambda d1, d2, pk, ok: ask.demod_slots_dense(
            cfg, d1, d2, s_per, c_per, pk, ok))(ds, dc, peaks, fire_ok)
    else:
        car, wts = ask.demod_tables(cfg)
        res = jax.vmap(lambda rp, pk, ok: jax.vmap(
            lambda p, o: ask.demod_slot(cfg, rp, car, wts, p, o)
        )(pk, ok))(rx_pads, peaks, fire_ok)
    return AskDecoded(**res), ~(overflow | bad)


demodulate_spec_jit = jax.jit(
    demodulate_spec,
    static_argnames=("cfg", "max_frames", "n_cand", "chain_window"))
