"""Speculative batched PHY decode: every candidate at once, then a walk.

The exact decoder (phy/decoder.py:decode_capture) replays the
reference's consumption loop as a ``lax.scan``: one candidate per step,
each step a chain of small dependent ops.  This module restructures the
same decisions so the sequential part shrinks to a pointer chase over
integers:

1. *Candidate extraction* (dense): every correlation hit becomes a
   candidate — per-128-lag-row hit rows from the correlator
   (sync/correlate.py:xcorr_hit_rows) rank-compacted into a sorted list
   of up to `C` positions.  More hits than `C` (or than the per-row /
   per-group caps) sets an overflow flag -> the caller falls back to
   the exact scan path.

2. *Attempts* (candidate-parallel): for each candidate, the exact
   decoder's own per-frame code — ±1-bit sync-word realignment
   (decoder.rs:158-217), header parse and full-frame line decode + CRC
   (decoder.rs:242-331) — vmapped over (capture, candidate), each on
   its contiguous window of the capture.

3. *Epilogue* (dense): length sanity, destination filter, and each
   candidate's consumption, stop and keep decision — everything the
   walk needs, independent of where the walk starts.

4. *Walk*: the sequential consumption walk over the candidate list as
   a vectorized pointer chase (decoder.rs:242-356's cursor decisions,
   exactly).  Because EVERY hit is in the candidate table (not just run
   starts), mid-run cursor landings are handled exactly; only candidate
   overflow — and, for 4B5B, a near-zero level average inside an
   attempted frame, whose skip-carry the optimistic line decode does
   not replay (line_coding.rs:265-269) — forces the exact path.
"""

from __future__ import annotations

import os as _os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.config import (
    FOUR_B_FIVE_B,
    FRAME_TYPE_DATA,
    MANCHESTER,
    PHY_HEADER_BYTES,
    PhyConfig,
)
from trackmaker_tpu.phy import decoder, line_coding
from trackmaker_tpu.sync import correlate

RPB = 4           # max hits per 128-lag row before overflow
BLK = 512
_BIGI = np.int32(2**30)


def spec_supported_cfg(cfg: PhyConfig) -> bool:
    """The configurations the speculative path is pinned against the
    exact scan for: the reference's Manchester and 4B5B line codes at 3
    samples per level (its default operating point)."""
    if cfg.samples_per_level != 3:
        return False
    if cfg.line_coding == MANCHESTER:
        return (cfg.preamble_len == 96 and cfg.sync_len == 48
                and cfg.sync_margin == 6 and cfg.header_samples == 336)
    if cfg.line_coding == FOUR_B_FIVE_B:
        return (cfg.preamble_len == 60 and cfg.sync_len == 30
                and cfg.sync_margin == 15 and cfg.header_samples == 210)
    return False


def _check_cfg(cfg: PhyConfig) -> None:
    assert spec_supported_cfg(cfg), \
        "the speculative decoder covers the spl=3 line-code configs"


# Walk-scan unroll factor (see _spec_walk_query); >= steps means a fully
# unrolled, while-loop-free chase.
WALK_UNROLL = max(1, int(_os.environ.get("TM_WALK_UNROLL", "8")))


def _spec_walk(fields, start_cursor, scan_limit, max_frames: int):
    """Vectorized consumption walk (decoder.rs:242-356) over the sorted
    candidate list — a batched pointer chase instead of a scalar loop.

    The walk is a chain in a functional graph, and candidate positions
    are SORTED, so it vectorizes exactly:

    * successor(c) = first index with pos >= pos_c + consumed_c — a
      per-pair compare + count along the sorted axis (no gather);
      stop candidates and candidates at/past the scan limit map to an
      absorbing sink (non-existence is a suffix property of the
      sorted list, so the chain can never skip past a hole).
    * the attempted set = the first `max_frames` nodes of the chain
      from s0 = first index with pos >= start_cursor, marked by a
      `lax.scan` pointer chase over the whole batch at once: each
      step ORs one-hot(ptr) into a visited bitmap and advances every
      row's pointer through the successor table.  Chain indices
      strictly increase (consumed >= 1), so min(max_frames, C+1) steps
      reach the sink.

    Returns ``(keep, attempted, final_cursor, done, pending)`` per
    capture.  `done` mirrors decode_capture's done_f: True when the
    walk ended on a stop or ran out of candidates — NOT when it merely
    hit `max_frames` attempts (the exact scan's remaining steps would
    then see no candidate and stop, decoder.py's `step`).
    Differentially pinned against a scalar transliteration of the walk
    rules by tests/test_blocked_spec.py::test_walk_vectorized_equals_smem."""
    prep = _spec_walk_prepare(fields, scan_limit, max_frames)
    return _spec_walk_query(prep, start_cursor, max_frames)


def _spec_walk_prepare(fields, scan_limit, max_frames: int):
    """Cursor-independent half of :func:`_spec_walk`: the per-candidate
    successor table (with the absorbing sink at index C).
    Blocked/sharded seam fixpoints call this ONCE and re-run only the
    cheap `_spec_walk_query` per iteration (only `start_cursor` changes
    across fixpoint iterations; `scan_limit` does not)."""
    b, _, c_n = fields.shape
    pos = fields[:, 0, :]                        # i32, ascending
    consumed = fields[:, 1, :]
    stopf = fields[:, 2, :] > 0
    keepf = fields[:, 3, :] > 0
    limit = jnp.broadcast_to(
        jnp.asarray(scan_limit, jnp.int32), (b,))
    exists = (pos < _BIGI) & (pos < limit[:, None])

    target = pos + consumed
    nxt = jnp.sum((pos[:, None, :] < target[:, :, None])
                  .astype(jnp.int32), axis=-1)   # (B, C) in [0, C]
    nxt = jnp.where(stopf | ~exists, c_n, nxt)
    nxt_ext = jnp.concatenate(                   # sink self-loop
        [nxt, jnp.full((b, 1), c_n, nxt.dtype)], axis=-1)

    return (nxt_ext, pos, consumed, stopf, keepf, exists)


def _spec_walk_query(prep, start_cursor, max_frames: int):
    """Cursor-dependent half of :func:`_spec_walk`: chase the successor
    chain from `start_cursor`'s first candidate and reduce the visited
    set to (keep, attempted, final_cursor, done, pending)."""
    nxt_ext, pos, consumed, stopf, keepf, exists = prep
    b, c_n = pos.shape
    cur0 = jnp.broadcast_to(
        jnp.asarray(start_cursor, jnp.int32), (b,))

    ar = jnp.arange(c_n + 1, dtype=jnp.int32)
    s0 = jnp.sum((pos < cur0[:, None]).astype(jnp.int32), axis=-1)
    # visited init derives from pos so its varying-axes typing matches
    # the scan body's output under shard_map
    vis0 = jnp.pad(pos * 0, ((0, 0), (0, 1))) > 0   # (B, C+1) False

    def step(carry, _):
        ptr, vis = carry
        onehot = ptr[:, None] == ar[None, :]
        nptr = jnp.sum(jnp.where(onehot, nxt_ext, 0), axis=-1)
        return (nptr.astype(ptr.dtype), vis | onehot), None

    # chain indices strictly increase, so C+1 steps always reach the
    # sink; extra steps past max_frames would only re-visit it
    steps = min(max_frames, c_n + 1)
    (_, visited), _ = jax.lax.scan(
        step, (s0.astype(jnp.int32), vis0), None, length=steps,
        unroll=min(steps, WALK_UNROLL))

    att = visited[:, :c_n] & exists
    keep = att & keepf & ~stopf   # stop candidates never yield a frame
    att_n = jnp.sum(att.astype(jnp.int32), axis=-1)
    stopped = jnp.any(att & stopf, axis=-1)
    pending = jnp.min(jnp.where(att & stopf, pos, _BIGI), axis=-1)
    adv_end = jnp.max(jnp.where(att & ~stopf, pos + consumed, -1),
                      axis=-1)
    cur_f = jnp.maximum(cur0, adv_end)
    done = stopped | (att_n < max_frames)
    return keep, att, cur_f, done, pending


def _pick_i32(vals: jax.Array, valid: jax.Array,
              onehot: jax.Array) -> jax.Array:
    """Rank-compact int32 values through a one-hot slot matrix with the
    16-bit-halves trick: a single f32 einsum is only integer-exact
    below 2^24, and flat long-capture positions reach 2^25 (600 s at
    48 kHz = 28.8M samples)."""
    v = jnp.where(valid, vals, 0)
    _hi = jax.lax.Precision.HIGHEST     # explicit: exact one-hot picks
    lo = jnp.einsum("...i,...ic->...c",
                    (v & 0xFFFF).astype(jnp.float32), onehot,
                    precision=_hi)
    hi = jnp.einsum("...i,...ic->...c",
                    (v >> 16).astype(jnp.float32), onehot,
                    precision=_hi)
    return (hi.astype(jnp.int32) << 16) + lo.astype(jnp.int32)


def _compact_hit_rows(rows: jax.Array, n_cand: int, rpb: int = RPB,
                      group: int = 32, s1: int = 16):
    """(cand, corr_at_cand, n_valid, overflow) from the correlator's
    per-128-lag-row hit rows (sync/correlate.py:xcorr_hit_rows) — the
    same candidate contract as :func:`_extract_candidates`, but
    hierarchical: stage 1 compacts each `group`-row block's
    `group*rpb` slots to `s1`, stage 2 rank-compacts the survivors
    globally, so no one-hot ever spans the whole capture.  Overflow adds
    one condition — more than `s1` extracted hits inside one
    group*128-lag span (4096 lags of audio at the defaults) —
    conservative like the others: flagged captures re-decode exactly.
    Position compaction uses 16-bit-halves einsums (integer-exact past
    2^24, where flat 600 s captures live)."""
    lead = rows.shape[:-2]
    r = rows.shape[-2]
    starts = rows[..., :rpb]
    cvals = jax.lax.bitcast_convert_type(
        rows[..., rpb + 1:2 * rpb + 1], jnp.float32)
    counts = rows[..., rpb]

    ng = -(-r // group)
    pad_r = ng * group - r
    if pad_r:
        pc = [(0, 0)] * len(lead)
        starts = jnp.pad(starts, pc + [(0, pad_r), (0, 0)],
                         constant_values=_BIGI)
        cvals = jnp.pad(cvals, pc + [(0, pad_r), (0, 0)])
        counts = jnp.pad(counts, pc + [(0, pad_r)])

    # stage 1: per-group rank compaction to s1 slots
    sg = starts.reshape(*lead, ng, group * rpb)
    cg = cvals.reshape(*lead, ng, group * rpb)
    vg = sg < _BIGI
    rank1 = jnp.cumsum(vg.astype(jnp.int32), axis=-1) - 1
    oh1 = (vg[..., None]
           & (rank1[..., None] == jnp.arange(s1, dtype=jnp.int32))
           ).astype(jnp.float32)
    grp_n = jnp.sum(vg.astype(jnp.int32), axis=-1)
    s_c = _pick_i32(sg, vg, oh1)
    c_c = jnp.einsum("...i,...ic->...c", jnp.where(vg, cg, 0.0), oh1,
                     precision=jax.lax.Precision.HIGHEST)
    s_c = jnp.where(jnp.arange(s1) < grp_n[..., None], s_c, _BIGI)

    # stage 2: global rank compaction of the survivors
    flat = s_c.reshape(*lead, ng * s1)
    cflat = c_c.reshape(*lead, ng * s1)
    valid = flat < _BIGI
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=-1) - 1
    onehot = (valid[..., None]
              & (rank[..., None] == jnp.arange(n_cand, dtype=jnp.int32))
              ).astype(jnp.float32)
    cand = _pick_i32(flat, valid, onehot)
    corr_c = jnp.einsum("...i,...ic->...c",
                        jnp.where(valid, cflat, 0.0), onehot,
                        precision=jax.lax.Precision.HIGHEST)
    n_valid = jnp.sum(valid.astype(jnp.int32), axis=-1)
    overflow = (jnp.any(counts > rpb, axis=-1)
                | jnp.any(grp_n > s1, axis=-1)
                | (jnp.sum(counts, axis=-1) > n_cand))
    cand = jnp.where(jnp.arange(n_cand) < n_valid[..., None],
                     cand, _BIGI)
    return cand, corr_c, n_valid, overflow


def _extract_candidates(hits: jax.Array, n_cand: int,
                        rpb: int = RPB, blk: int = BLK):
    """All hit positions, ascending, padded with 2^30 — via per-block
    argmax peel + rank compaction (dense ops only, no `nonzero`).
    `rpb` caps hits per `blk`-lag block before the overflow flag fires
    (the ASK receiver's fire-candidates are denser than preamble hits
    and use a higher cap)."""
    n = hits.shape[-1]
    hb = -(-n // blk)
    rows = jnp.pad(hits, [(0, 0)] * (hits.ndim - 1)
                   + [(0, hb * blk - n)]).reshape(*hits.shape[:-1], hb, blk)
    lane = jnp.arange(blk, dtype=jnp.int32)
    base = jnp.arange(hb, dtype=jnp.int32) * blk
    starts = []
    r = rows
    for _ in range(rpb):
        has = jnp.any(r, axis=-1)
        p = jnp.argmax(r, axis=-1).astype(jnp.int32)
        starts.append(jnp.where(has, base + p, _BIGI))
        r = r & (lane > p[..., None])
    per_block = jnp.sum(rows.astype(jnp.int32), axis=-1)
    overflow = jnp.any(per_block > rpb, axis=-1) | (
        jnp.sum(per_block, axis=-1) > n_cand)
    flat = jnp.stack(starts, axis=-1).reshape(*hits.shape[:-1], hb * rpb)
    valid = flat < _BIGI
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=-1) - 1
    onehot = (valid[..., None]
              & (rank[..., None] == jnp.arange(n_cand, dtype=jnp.int32))
              ).astype(jnp.float32)
    cand = jnp.einsum("...i,...ic->...c",
                      jnp.where(valid, flat, 0).astype(jnp.float32),
                      onehot, precision=jax.lax.Precision.HIGHEST)
    n_valid = jnp.sum(valid.astype(jnp.int32), axis=-1)
    cand = jnp.where(jnp.arange(n_cand) < n_valid[..., None],
                     cand.astype(jnp.int32), _BIGI)
    return cand, n_valid, overflow


class SpecFields(NamedTuple):
    """Cursor-independent per-candidate decode products (phase A).

    Everything here depends only on the capture, not on where the
    consumption walk starts — so blocked/sharded callers can compute it
    ONCE and re-run only the (tiny) walk inside their consumed-until
    seam fixpoint (parallel/stream.py)."""
    cand: jax.Array       # i32[B, C] candidate preamble starts (_BIGI pad)
    fields: jax.Array     # i32[B, 4, C] walk rows: pos/consumed/stop/keep
    overflow: jax.Array   # bool[B] candidate table overflowed
    nonconf: jax.Array    # bool[B, C] optimistic decode unsound if attempted
    bytes_m: jax.Array    # u8[B, C, n_total] frame bytes, masked to length
    dlen: jax.Array       # i32[B, C]
    ftype: jax.Array      # i32[B, C]
    seq: jax.Array        # i32[B, C]
    src: jax.Array        # i32[B, C]
    dst: jax.Array        # i32[B, C]
    corr: jax.Array       # f32[B, C] correlation at each candidate


def _spec_phase_a(
    cfg: PhyConfig,
    x: jax.Array,              # f32[B, T]; f32[T_flat] with flat_blocks
    local_addr: jax.Array,     # i32 scalar
    n_cand: int,
    vlens: jax.Array,          # i32[B]
    flat_blocks: tuple[int, int] | None = None,
) -> SpecFields:
    """Dense correlation + candidate extraction + candidate-parallel
    attempts + decision epilogue — every per-candidate quantity the
    consumption walk needs, computed for ALL candidates independent of
    the cursor.

    ``flat_blocks=(n_blocks, block)`` is the long-capture mode: x is
    ONE flat capture (pre-padded to n_blocks*block, block % 128 == 0),
    correlated once with no halo duplication; the per-128-lag hit rows
    split into per-block candidate tables by reshape (positions stay
    GLOBAL), and every attempt reads its window from the one shared
    buffer — so a frame near a block seam reads the real following
    samples and no windowed copy of the capture ever exists.  Walk
    cursors/limits for this mode are global sample positions
    (parallel/stream.py)."""
    if flat_blocks is None:
        b, t = x.shape
    else:
        n_blocks, block = flat_blocks
        assert x.ndim == 1 and block % 128 == 0
        b = n_blocks
        t = x.shape[-1]
    opt = cfg.line_coding != MANCHESTER   # 4B5B: optimistic line decode
    l_pre, sync_len = cfg.preamble_len, cfg.sync_len

    pre_np = line_coding.preamble_waveform(cfg)
    rows = correlate.xcorr_hit_rows(x, pre_np, cfg.correlation_threshold,
                                    rpb=RPB)
    if flat_blocks is not None:
        rows = rows[: n_blocks * (block // 128)].reshape(
            n_blocks, block // 128, 16)
    cand, corr_cand, _n_valid, overflow = _compact_hit_rows(rows, n_cand)

    pad = [(0, 0)] * (x.ndim - 1) + [(0, decoder.window_pad(cfg))]
    padded = jnp.pad(x, pad)

    def attempt(row, vlen, pos):
        """The exact scan's per-candidate work (decoder.py `step`) for a
        candidate at preamble start `pos`."""
        i = jnp.minimum(pos, t)
        best_pos, slab_ctx = decoder.sync_refine(
            cfg, row, vlen, i + (l_pre - sync_len))
        fs = best_pos + sync_len
        h = decoder.decode_header(cfg, fs, slab_ctx, optimistic=opt)
        body = decoder.decode_body(cfg, row, fs, h["data_len"],
                                   optimistic=opt)
        return fs, h, body

    per_capture = jax.vmap(attempt, in_axes=(None, None, 0))
    row_axis = None if flat_blocks is not None else 0
    fs, h, body = jax.vmap(per_capture, in_axes=(row_axis, 0, 0))(
        padded, vlens, cand)

    n_total = PHY_HEADER_BYTES + cfg.max_frame_bytes
    dlen, ftype, dst = h["data_len"], h["ftype"], h["dst"]
    header_ok = h["header_ok"]
    len_bad = ((ftype == FRAME_TYPE_DATA) & (dlen == 0)) | (
        dlen > cfg.max_frame_bytes)
    total_samples = decoder._samples_for_bits_traced(
        cfg, (PHY_HEADER_BYTES + dlen) * 8)
    vl = vlens[:, None]
    hdr_incomplete = fs + cfg.header_samples > vl
    incomplete = fs + total_samples > vl
    dst_ok = (dst == local_addr) | (local_addr < 0)
    crc_ok = body.crc.astype(jnp.int32) == h["crc_field"]
    bytes_m = jnp.where(
        jnp.arange(n_total) < (PHY_HEADER_BYTES + dlen)[..., None],
        body.bytes_full, 0).astype(jnp.uint8)

    # consumption / stop / keep rules of decoder.py `step`
    # (decoder.rs:266-356), per candidate
    consumed = jnp.where(
        ~header_ok, cfg.header_samples,
        jnp.where(len_bad, 1,
                  jnp.where(body.line_fail,
                            l_pre + decoder._samples_for_bits_traced(
                                cfg, body.n_valid_bits),
                            l_pre + total_samples)))
    stopf = hdr_incomplete | (header_ok & ~len_bad & incomplete)
    keepf = (~hdr_incomplete & header_ok & ~len_bad & ~incomplete
             & ~body.line_fail & dst_ok & crc_ok)
    fields = jnp.stack(
        [cand, consumed, stopf.astype(jnp.int32), keepf.astype(jnp.int32)],
        axis=1).astype(jnp.int32)                         # (B, 4, C)
    # 4B5B: a near-zero level average in the header window or inside the
    # frame could change bits through the reference's skip-carry
    nonconf = h["hdr_zero"] | body.near0

    return SpecFields(cand=cand, fields=fields, overflow=overflow,
                      nonconf=nonconf, bytes_m=bytes_m, dlen=dlen,
                      ftype=ftype, seq=h["seq"], src=h["src"], dst=dst,
                      corr=corr_cand)


def _spec_compact(a: SpecFields, keep: jax.Array, max_frames: int):
    """Compact kept candidates to the leading `max_frames` slots in
    position order (phase C): slot k takes the candidate of rank k
    among the kept ones."""
    rank = jnp.cumsum(keep.astype(jnp.int32), axis=-1) - 1
    sel = keep[:, None, :] & (
        rank[:, None, :] == jnp.arange(max_frames)[None, :, None])
    any_k = jnp.any(sel, axis=-1)                        # (B, K)
    src_idx = jnp.argmax(sel, axis=-1)                   # (B, K)

    def pick(arr, fill):
        if arr.ndim == 2:                                # (B, C)
            out = jnp.take_along_axis(arr, src_idx, axis=1)
            return jnp.where(any_k, out, fill)
        out = jnp.take_along_axis(arr, src_idx[..., None], axis=1)
        return jnp.where(any_k[..., None], out, fill)    # (B, K, N)

    from trackmaker_tpu.phy.decoder import DecodedFrames
    return DecodedFrames(
        valid=any_k,
        frame_bytes=pick(a.bytes_m, 0).astype(jnp.uint8),
        length=pick(a.dlen, 0),
        frame_type=pick(a.ftype, 0),
        sequence=pick(a.seq, 0),
        src=pick(a.src, 0),
        dst=pick(a.dst, 0),
        start=pick(a.cand, -1),
        corr=pick(a.corr, 0.0),
    )


def decode_capture_spec(
    cfg: PhyConfig,
    samples: jax.Array,          # f32[B, T]
    local_addr,
    max_frames: int = 64,
    n_cand: int = 128,
    valid_len=None,
    start_cursor=None,
    scan_limit=None,
    with_cursor: bool = False,
):
    """Batched speculative decode.  Returns ``(DecodedFrames, ok[B])``;
    rows with ``ok=False`` (candidate overflow, or — 4B5B — a near-zero
    level average whose skip-carry the optimistic line decode cannot
    replay) must be re-decoded with the exact path —
    :func:`trackmaker_tpu.phy.decoder.decode_capture_fast` does this
    automatically.  Valid frames are compacted to the leading slots in
    position order (the exact path instead leaves failed attempts as
    invalid slots in between; the valid-masked content is identical).

    `start_cursor`, `scan_limit` and `with_cursor` mirror
    :func:`trackmaker_tpu.phy.decoder.decode_capture`'s blocked-decode
    cursor semantics (per capture row here); with ``with_cursor=True``
    the return is ``(frames, ok, searched_until[B], final_cursor[B])``.
    Blocked callers that iterate the seam fixpoint should use
    :func:`_spec_phase_a` + :func:`_spec_walk` directly so phase A runs
    once (parallel/stream.py)."""
    _check_cfg(cfg)
    x = jnp.asarray(samples, jnp.float32)
    assert x.ndim == 2
    b, t = x.shape
    local_addr = jnp.asarray(local_addr, jnp.int32)
    vlens = jnp.broadcast_to(
        jnp.asarray(t if valid_len is None else valid_len, jnp.int32), (b,))

    a = _spec_phase_a(cfg, x, local_addr, n_cand, vlens)
    cur0 = 0 if start_cursor is None else start_cursor
    limit = int(_BIGI) if scan_limit is None else scan_limit
    keep, attempted, cur_f, done, pending = _spec_walk(
        a.fields, cur0, limit, max_frames)
    res = _spec_compact(a, keep, max_frames)
    ok = ~(a.overflow | jnp.any(attempted & a.nonconf, axis=-1))
    if not with_cursor:
        return res, ok
    searched_until = jnp.clip(
        jnp.where(pending < _BIGI, pending,
                  jnp.where(done, vlens - (cfg.preamble_len - 1), cur_f)),
        0, vlens)
    return res, ok, searched_until, cur_f


decode_capture_spec_jit = jax.jit(
    decode_capture_spec,
    static_argnames=("cfg", "max_frames", "n_cand", "with_cursor"))
