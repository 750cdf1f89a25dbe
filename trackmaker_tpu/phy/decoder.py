"""Batched PHY decoder: 48 kHz capture -> frames, as one XLA program.

The reference decoder is an online, data-dependent state machine
(``src/phy/decoder.rs``): scan window-by-window for a preamble correlation
>= 0.9, refine alignment on the sync word, decode a length-delimited frame,
CRC-check, resume.  An accelerator can't profitably run that loop
sample-by-sample, so the design is **two-phase**:

1. *Dense phase (parallel):* normalized cross-correlation against the
   preamble over every lag at once (``trackmaker_tpu.sync``), thresholded
   into a candidate list — this is ~all the FLOPs and runs wide.

2. *Consumption phase (tiny sequential):* a ``lax.scan`` over at most
   `max_frames` steps replays the reference's *decisions* exactly — first
   candidate past the cursor, ±1-bit sync refinement (argmax, first-wins
   ties like the reference's strict `>` update, decoder.rs:204-207),
   header parse, length sanity (decoder.rs:277-286), full-frame line
   decode, destination filter, CRC — using fixed-size windows and
   pad-and-mask.  Each step does O(max_frame_samples) work, so the scan is
   a rounding error next to phase 1.

Everything is fixed-shape; `vmap` batches whole recordings.  Consumption
rules (what advances the cursor in each failure mode) mirror
decoder.rs:242-356 so decoded frame sequences are bit-identical to the
reference on the same captures.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import (
    FOUR_B_FIVE_B,
    FRAME_TYPE_DATA,
    MANCHESTER,
    PHY_HEADER_BYTES,
    PhyConfig,
)
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy import line_coding
from trackmaker_tpu.sync import correlate

_BIG = 2**30  # plain int: no device put at import time


def _samples_for_bits_traced(cfg: PhyConfig, num_bits: jax.Array) -> jax.Array:
    """Traced version of PhyConfig.samples_for_bits."""
    if cfg.line_coding == MANCHESTER:
        return num_bits * (cfg.samples_per_level * 2)
    elif cfg.line_coding == FOUR_B_FIVE_B:
        return ((num_bits + 3) // 4) * (5 * cfg.samples_per_level)
    raise ValueError(cfg.line_coding)


class DecodedFrames(NamedTuple):
    """Fixed-size decode results (pad-and-mask over `max_frames` slots)."""

    valid: jax.Array        # bool[K]   CRC-passed frame addressed to us
    frame_bytes: jax.Array  # uint8[K, 7+max_frame_bytes] (zero-padded)
    length: jax.Array       # int32[K]  payload length
    frame_type: jax.Array   # int32[K]
    sequence: jax.Array     # int32[K]
    src: jax.Array          # int32[K]
    dst: jax.Array          # int32[K]
    start: jax.Array        # int32[K]  preamble start sample index
    corr: jax.Array         # f32[K]    detection correlation

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)

    def to_frames(self, row: int | None = None) -> list[Frame]:
        """Host-side: materialize valid slots as Frame objects.  For
        batched results pass `row` to pick one capture's slots."""
        valid = np.asarray(self.valid)
        fb = np.asarray(self.frame_bytes)
        ln = np.asarray(self.length)
        if row is not None:
            valid, fb, ln = valid[row], fb[row], ln[row]
        out = []
        for k in np.nonzero(valid)[0]:
            raw = fb[k, : PHY_HEADER_BYTES + ln[k]].tobytes()
            f = Frame.from_bytes(raw)
            assert f is not None
            out.append(f)
        return out


def window_pad(cfg: PhyConfig) -> int:
    """Zero padding past a capture's end that keeps every fixed-size
    per-frame window below (sync slab, header, full frame) in bounds
    for any preamble start in [0, T]."""
    return (cfg.samples_for_bits((PHY_HEADER_BYTES + cfg.max_frame_bytes) * 8)
            + cfg.preamble_len + cfg.sync_margin + cfg.sync_len + 8)


def _sync_slab_len(cfg: PhyConfig) -> int:
    # one slab covers both the sync realignment windows (max offset
    # 2*margin + sync_len) and every possible header window
    # (frame_start <= base + 2*margin + sync_len)
    return 2 * cfg.sync_margin + cfg.sync_len + cfg.header_samples


def sync_refine(
    cfg: PhyConfig, padded: jax.Array, vlen: jax.Array, expected: jax.Array,
) -> tuple[jax.Array, tuple[jax.Array, jax.Array]]:
    """±1-bit sync-word realignment (decoder.rs:158-217) around the
    nominal sync-word start `expected` of a zero-padded capture.
    Returns (best position, (slab, base)) — the slab also holds every
    header window, so :func:`decode_header` reuses it."""
    pre_np = line_coding.preamble_waveform(cfg)
    sync_len, margin = cfg.sync_len, cfg.sync_margin
    sync_np = pre_np[len(pre_np) - sync_len:]
    sync_pat = jnp.asarray(sync_np)
    sync_energy = correlate.preamble_energy(sync_np)
    n_pos = 2 * margin + 1

    base = jnp.clip(expected - margin, 0)
    pos = base + jnp.arange(n_pos, dtype=jnp.int32)
    valid = ((pos >= expected - margin) & (pos <= expected + margin)
             & (pos <= vlen - sync_len))
    slab = jax.lax.dynamic_slice(padded, (base,), (_sync_slab_len(cfg),))
    wins = jnp.stack(
        [jax.lax.slice(slab, (k,), (k + sync_len,)) for k in range(n_pos)])
    dot = jnp.dot(wins, sync_pat, precision=jax.lax.Precision.HIGHEST)
    we = jnp.sum(wins * wins, axis=-1)
    c = jnp.where((we > 1e-6) & (sync_energy > 1e-6),
                  dot / (jnp.sqrt(we) * sync_energy), 0.0)
    c = jnp.where(valid, c, -jnp.inf)
    best = jnp.argmax(c)  # first max wins ties, like strict `>` update
    bestpos = jnp.where(jnp.max(c) > -1.0, pos[best], expected)
    return bestpos, (slab, base)


def decode_header(cfg: PhyConfig, frame_start: jax.Array, slab_ctx,
                  optimistic: bool = False) -> dict:
    """Header fields of the frame at `frame_start` (decoder.rs:242-286),
    read from :func:`sync_refine`'s slab.  ``header_ok`` needs >= 49
    decoded bits and a known frame type.  With `optimistic` (4B5B) the
    header decodes without the near-zero-level carry and ``hdr_zero``
    flags any near-zero level in the window (the carry could change the
    bits there)."""
    slab, base = slab_ctx
    header_samples, header_bits = cfg.header_samples, cfg.header_bits
    off = jnp.clip(frame_start - base, 0,
                   _sync_slab_len(cfg) - header_samples)
    hdr_win = jax.lax.dynamic_slice(slab, (off,), (header_samples,))
    if optimistic:
        hdr_bits, hdr_ok, near0 = line_coding.fourb5b_decode_opt(
            hdr_win, cfg.samples_per_level)
        hdr_zero = jnp.any(near0)
    else:
        hdr_bits, hdr_ok = line_coding.decode(cfg, hdr_win)
        hdr_zero = jnp.asarray(False)
    n_valid_hdr = jnp.sum(hdr_ok[:header_bits].astype(jnp.int32))
    hdr_bits = jnp.where(
        jnp.arange(header_bits) < n_valid_hdr, hdr_bits[:header_bits], 0)
    hdr_bytes = bitops.pack_bits(hdr_bits)
    fields = {
        "data_len": (hdr_bytes[0].astype(jnp.int32) << 8) | hdr_bytes[1],
        "crc_field": hdr_bytes[2].astype(jnp.int32),
        "ftype": hdr_bytes[3].astype(jnp.int32),
        "seq": hdr_bytes[4].astype(jnp.int32),
        "src": hdr_bytes[5].astype(jnp.int32),
        "dst": hdr_bytes[6].astype(jnp.int32),
    }
    # parse_header needs 7 whole-or-partial bytes: >=49 decoded bits
    # (bits_to_bytes zero-fills the tail, crc.rs:63-75)
    type_ok = (fields["ftype"] == 1) | (fields["ftype"] == 2)
    fields["header_ok"] = (n_valid_hdr >= 49) & type_ok
    fields["hdr_zero"] = hdr_zero
    return fields


class FrameBody(NamedTuple):
    bytes_full: jax.Array    # uint8[7+max_frame_bytes], zero past the frame
    n_valid_bits: jax.Array  # i32: decoded bits before the first invalid one
    line_fail: jax.Array     # bool: fewer valid bits than the frame holds
    crc: jax.Array           # uint8: CRC8 of the decoded payload
    near0: jax.Array         # bool: near-zero level inside the frame
    #                          (optimistic 4B5B only; else False)


def decode_body(cfg: PhyConfig, padded: jax.Array, frame_start: jax.Array,
                data_len: jax.Array, optimistic: bool = False) -> FrameBody:
    """Full-window line decode + CRC of the frame at `frame_start`
    (decoder.rs:287-331).  `optimistic` decodes 4B5B without the
    near-zero-level carry and reports such levels in ``near0``."""
    max_total_bytes = PHY_HEADER_BYTES + cfg.max_frame_bytes
    total_bits = (PHY_HEADER_BYTES + data_len) * 8
    body_win = jax.lax.dynamic_slice(
        padded, (jnp.clip(frame_start, 0),),
        (cfg.samples_for_bits(max_total_bytes * 8),))
    if optimistic:
        bits, bit_ok, near0 = line_coding.fourb5b_decode_opt(
            body_win, cfg.samples_per_level)
        lvl_in_frame = jnp.arange(near0.shape[-1]) < (total_bits // 4) * 5
        near0 = jnp.any(near0 & lvl_in_frame)
    else:
        bits, bit_ok = line_coding.decode(cfg, body_win)
        near0 = jnp.asarray(False)
    in_frame = jnp.arange(bits.shape[-1]) < total_bits
    n_valid_bits = jnp.sum((bit_ok & in_frame).astype(jnp.int32))
    masked_bits = jnp.where(in_frame, bits, 0)
    payload_bits = masked_bits[PHY_HEADER_BYTES * 8: max_total_bytes * 8]
    crc = bitops.crc8_bits_matmul(
        payload_bits, jnp.clip(data_len, 0, cfg.max_frame_bytes))
    return FrameBody(
        bytes_full=bitops.pack_bits(masked_bits[: max_total_bytes * 8]),
        n_valid_bits=n_valid_bits, line_fail=n_valid_bits < total_bits,
        crc=crc, near0=near0)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_frames", "with_cursor", "optimistic"))
def decode_capture(
    cfg: PhyConfig,
    samples: jax.Array,          # f32[T]
    local_addr: jax.Array | int,
    max_frames: int = 64,
    valid_len: jax.Array | int | None = None,
    with_cursor: bool = False,
    start_cursor: jax.Array | int | None = None,
    scan_limit: jax.Array | int | None = None,
    optimistic: bool = False,
) -> DecodedFrames:
    """Decode one capture. vmap over a leading batch axis for batches.

    `valid_len` marks the true capture length when `samples` is a
    zero-padded bucket (streaming callers pad to fixed sizes to avoid
    one compile per buffer length); frames whose body would extend past
    it are treated as incomplete, like the reference's wait-for-more-data
    path (decoder.rs:252-254, 295-297).

    With `with_cursor=True` returns ``(frames, searched_until,
    final_cursor)``: `searched_until` is the sample index a streaming
    caller may drain to — the start of a pending incomplete frame if
    the scan stopped on one, else `valid_len - (preamble_len - 1)` once
    the search exhausted all candidates (the reference's
    overlap-preserving drain, decoder.rs:89-109), else the scan cursor
    when `max_frames` ran out.  `final_cursor` is the raw consumption
    cursor after the last attempted candidate — the blocked/sharded
    decoder's seam-reconciliation signal (parallel/stream.py).

    `start_cursor` begins the sequential walk at that sample (hits
    before it are skipped — they were consumed by an upstream block);
    `scan_limit` ends it at the first candidate >= that sample (those
    belong to the downstream block).  Both are dynamic values: no
    recompilation per distinct value.

    `optimistic` (4B5B only) moves the body decode out of the scan like
    Manchester by *assuming* no invalid 4B5B symbol occurs inside any
    attempted frame (the invalid-symbol consumption rule,
    decoder.rs:306-320, is the one thing that makes 4B5B cursor
    arithmetic depend on the body).  Returns ``(frames, conformant)``;
    when `conformant` is False some attempted slot line-failed, the
    optimistic cursor walk is unsound from that point, and the caller
    must re-decode with the exact path (see
    :func:`decode_capture_fast`).
    """
    if optimistic:
        assert cfg.line_coding == FOUR_B_FIVE_B, \
            "optimistic mode is the 4B5B fast path"
        assert not with_cursor, "optimistic mode has no cursor semantics"
    samples = samples.astype(jnp.float32)
    t = samples.shape[-1]
    local_addr = jnp.asarray(local_addr, jnp.int32)
    vlen = jnp.asarray(t if valid_len is None else valid_len, jnp.int32)
    cursor0 = jnp.asarray(
        0 if start_cursor is None else start_cursor, jnp.int32)
    limit = (_BIG if scan_limit is None
             else jnp.asarray(scan_limit, jnp.int32))

    pre_np = line_coding.preamble_waveform(cfg)
    l_pre = len(pre_np)
    pre_energy = correlate.preamble_energy(pre_np)
    sync_len = cfg.sync_len
    header_samples = cfg.header_samples
    max_total_bytes = PHY_HEADER_BYTES + cfg.max_frame_bytes

    if t < l_pre:  # capture shorter than the preamble: nothing to find
        samples = jnp.pad(samples, (0, l_pre - t))
        t = l_pre

    # ---- phase 1: dense correlation + candidate extraction ----------------
    corr = correlate.normalized_xcorr(samples, pre_np, pre_energy)
    hits = corr >= cfg.correlation_threshold
    # Two-level block index for "first hit >= cursor" queries: two tiny
    # argmax lookups per scan step instead of a global compaction.
    blk = 512
    n_corr = hits.shape[-1]
    hb = -(-n_corr // blk)
    hits_blocks = jnp.pad(hits, (0, hb * blk - n_corr)).reshape(hb, blk)
    block_any = jnp.any(hits_blocks, axis=1)
    lane = jnp.arange(blk, dtype=jnp.int32)
    brange = jnp.arange(hb, dtype=jnp.int32)

    def first_hit_from(cursor):
        """(first hit index >= cursor, exists)."""
        c = jnp.clip(cursor, 0, hb * blk - 1)
        jb = c // blk
        off = c % blk
        row = hits_blocks[jb]
        m1 = row & (lane >= off)
        has1 = jnp.any(m1)
        i1 = jb * blk + jnp.argmax(m1)
        m2 = block_any & (brange > jb)
        has2 = jnp.any(m2)
        b2 = jnp.argmax(m2)
        i2 = b2 * blk + jnp.argmax(hits_blocks[b2])
        first = jnp.where(has1, i1, jnp.where(has2, i2, _BIG))
        return first.astype(jnp.int32), has1 | has2

    # zero-pad so every fixed-size dynamic_slice below stays in bounds
    padded = jnp.concatenate(
        [samples, jnp.zeros(window_pad(cfg), jnp.float32)])

    # Manchester line decode never truncates (no invalid symbols), so the
    # cursor advance is fully determined by the *header* — the expensive
    # full-window body decode can then move OUT of the sequential scan
    # into a post-pass vmapped over all frame slots at once.  4B5B's
    # invalid-symbol consumption rule (decoder.rs:311-319) needs the body
    # inside the scan — unless `optimistic` defers it to the post-pass
    # with a conformance check.
    body_in_scan = cfg.line_coding != MANCHESTER and not optimistic

    def step(carry, _):
        cursor, done, pending = carry

        first, has_cand = first_hit_from(cursor)
        # candidates at/past scan_limit belong to the downstream block:
        # treat them as absent (ends the walk with the cursor unchanged)
        has_cand = has_cand & (first < limit)
        i = jnp.clip(first, 0, t)  # preamble start (abs)

        # --- sync refinement + frame start
        expected = i + (l_pre - sync_len)
        best_pos, slab_ctx = sync_refine(cfg, padded, vlen, expected)
        frame_start = best_pos + sync_len

        # reference waits for more data when the header spills past the
        # buffer end (decoder.rs:252-254); at end-of-capture that means
        # the stream is done.
        hdr_incomplete = frame_start + header_samples > vlen
        h = decode_header(cfg, frame_start, slab_ctx, optimistic)
        data_len, ftype = h["data_len"], h["ftype"]
        header_ok = h["header_ok"]

        len_bad = ((ftype == FRAME_TYPE_DATA) & (data_len == 0)) | (
            data_len > cfg.max_frame_bytes)

        total_bits = (PHY_HEADER_BYTES + data_len) * 8
        total_samples = _samples_for_bits_traced(cfg, total_bits)
        incomplete = frame_start + total_samples > vlen

        if body_in_scan:
            body = decode_body(cfg, padded, frame_start, data_len)
            bytes_full = body.bytes_full
            n_valid_bits, line_fail = body.n_valid_bits, body.line_fail
            crc_ok = body.crc.astype(jnp.int32) == h["crc_field"]
        else:
            bytes_full = jnp.zeros(max_total_bytes, jnp.uint8)
            n_valid_bits = total_bits
            line_fail = jnp.asarray(False)
            crc_ok = jnp.asarray(True)  # resolved in the post-pass
        # local_addr < 0 => promiscuous (accept any destination)
        dst_ok = (h["dst"] == local_addr) | (local_addr < 0)

        # --- consumption rules (decoder.rs:266-356)
        consumed = jnp.where(
            ~header_ok,
            header_samples,
            jnp.where(
                len_bad,
                1,
                jnp.where(
                    line_fail,
                    l_pre + _samples_for_bits_traced(cfg, n_valid_bits),
                    l_pre + total_samples,
                ),
            ),
        )

        attempt_ok = (has_cand & ~done & ~hdr_incomplete & header_ok
                      & ~len_bad & ~incomplete & ~line_fail & dst_ok)
        frame_valid = attempt_ok & crc_ok
        stop = done | ~has_cand | (has_cand & hdr_incomplete) | (
            has_cand & ~hdr_incomplete & header_ok & ~len_bad & incomplete)
        # a stop on an *incomplete* frame pins the drain point to its
        # preamble start: the streaming caller must keep it buffered
        # (decoder.rs:252-254, 295-297 wait-for-more-data)
        wait_here = has_cand & ~done & (
            hdr_incomplete | (~hdr_incomplete & header_ok & ~len_bad
                              & incomplete))
        new_pending = jnp.minimum(pending, jnp.where(wait_here, i, _BIG))
        new_cursor = jnp.where(stop, cursor, i + consumed)
        new_done = stop

        keep = frame_valid if body_in_scan else attempt_ok
        mask_b = jnp.where(
            keep,
            jnp.where(jnp.arange(max_total_bytes) <
                      PHY_HEADER_BYTES + data_len, bytes_full, 0),
            jnp.zeros_like(bytes_full))

        out = dict(
            valid=keep,
            frame_bytes=mask_b.astype(jnp.uint8),
            length=jnp.where(keep, data_len, 0),
            frame_type=jnp.where(keep, ftype, 0),
            sequence=jnp.where(keep, h["seq"], 0),
            src=jnp.where(keep, h["src"], 0),
            dst=jnp.where(keep, h["dst"], 0),
            start=jnp.where(keep, i, -1),
            corr=jnp.where(
                keep, corr[jnp.clip(i, 0, corr.shape[-1] - 1)], 0.0),
        )
        if not body_in_scan:
            out["frame_start"] = jnp.where(keep, frame_start, 0)
            out["crc_field"] = jnp.where(keep, h["crc_field"], 0)
        if optimistic:
            # conformance needs line_fail for EVERY attempted slot —
            # including dst-filtered ones, whose consumption also
            # depends on it (decoder.rs:306-329) — and a near-zero
            # level in ANY examined header window (the carry rule
            # could change header bytes without an invalid symbol)
            att = (has_cand & ~done & ~hdr_incomplete & header_ok
                   & ~len_bad & ~incomplete)
            out["att"] = att
            out["fs_all"] = jnp.where(att, frame_start, 0)
            out["len_all"] = jnp.where(att, data_len, 0)
            out["hdr_nonconf"] = has_cand & ~done & h["hdr_zero"]
        return (new_cursor, new_done, new_pending), out

    (cursor_f, done_f, pending_f), ys = jax.lax.scan(
        step,
        # derive the init carry from vlen so its sharding/varying type
        # matches the loop outputs under shard_map
        ((vlen * 0 + cursor0).astype(jnp.int32), vlen < 0,
         (vlen * 0 + _BIG).astype(jnp.int32)),
        None, length=max_frames,
        # unrolling amortizes the while-loop per-iteration overhead,
        # which dominates this scan (each step is tiny)
        unroll=min(8, max_frames))

    searched_until = jnp.clip(
        jnp.where(
            pending_f < _BIG,
            pending_f,
            jnp.where(done_f, vlen - (l_pre - 1), cursor_f)),
        0, vlen)

    if body_in_scan:
        res = DecodedFrames(**ys)
        return (res, searched_until, cursor_f) if with_cursor else res

    # ---- post-pass: body decode + CRC for all slots at once (Manchester
    # always; 4B5B in optimistic mode, plus the conformance check)
    frame_starts = ys.pop("frame_start")
    crc_fields = ys.pop("crc_field")

    if optimistic:
        att = ys.pop("att")
        fs_all = ys.pop("fs_all")
        len_all = ys.pop("len_all")
        hdr_nonconf = ys.pop("hdr_nonconf")

        def body_slot_opt(fs, dlen, cf, keep):
            body = decode_body(cfg, padded, fs, dlen, optimistic=True)
            nonconf = body.line_fail | body.near0
            ok = (body.crc.astype(jnp.int32) == cf) & keep & ~nonconf
            masked = jnp.where(
                ok & (jnp.arange(max_total_bytes) <
                      PHY_HEADER_BYTES + dlen), body.bytes_full, 0)
            return masked.astype(jnp.uint8), ok, nonconf

        frame_bytes, valid, nonconfs = jax.vmap(body_slot_opt)(
            fs_all, len_all, crc_fields, ys["valid"])
        conformant = ~(jnp.any(att & nonconfs) | jnp.any(hdr_nonconf))
    else:
        def body_slot(fs, dlen, cf, attempted):
            body = decode_body(cfg, padded, fs, dlen)
            crc_ok = (body.crc.astype(jnp.int32) == cf) & attempted
            masked = jnp.where(
                crc_ok & (jnp.arange(max_total_bytes) <
                          PHY_HEADER_BYTES + dlen), body.bytes_full, 0)
            return masked.astype(jnp.uint8), crc_ok

        frame_bytes, valid = jax.vmap(body_slot)(
            frame_starts, ys["length"], crc_fields, ys["valid"])
    z = jnp.int32(0)
    ys.update(
        valid=valid,
        frame_bytes=frame_bytes,
        length=jnp.where(valid, ys["length"], z),
        frame_type=jnp.where(valid, ys["frame_type"], z),
        sequence=jnp.where(valid, ys["sequence"], z),
        src=jnp.where(valid, ys["src"], z),
        dst=jnp.where(valid, ys["dst"], z),
        start=jnp.where(valid, ys["start"], -1),
        corr=jnp.where(valid, ys["corr"], 0.0),
    )
    res = DecodedFrames(**ys)
    if optimistic:
        return res, conformant
    return (res, searched_until, cursor_f) if with_cursor else res


@functools.lru_cache(maxsize=64)
def _batched_fn(cfg, max_frames, optimistic):
    return jax.jit(jax.vmap(
        lambda s, a, v: decode_capture(cfg, s, a, max_frames,
                                       valid_len=v, optimistic=optimistic),
        in_axes=(0, None, 0)))


def decode_capture_fast(
    cfg: PhyConfig,
    samples,                     # f32[T] or f32[B, T]
    local_addr: int,
    max_frames: int = 64,
    valid_len=None,              # i32[] / i32[B]: true lengths of
    #                              zero-padded capture rows (bucketed
    #                              callers keep jit shape counts low)
) -> DecodedFrames:
    """Host-level batch decode picking the fastest sound path.

    Configurations the speculative decoder covers
    (:func:`trackmaker_tpu.phy.spec_decode.spec_supported_cfg`) run it
    (candidate table + candidate-parallel attempts + vectorized walk);
    rows whose candidate table overflowed — or, 4B5B, whose attempted
    candidates hit a near-zero level average (the optimistic NRZI rule
    cannot replay the reference's skip-carry) — re-decode exactly.
    Other configurations take the exact scan (Manchester) or the
    optimistic two-pass (4B5B).  Results always equal
    :func:`decode_capture` up to slot compaction (the speculative path
    packs valid frames into the leading slots; the valid-masked content
    is identical)."""
    x = jnp.asarray(samples)
    batched = x.ndim == 2
    vlen = jnp.asarray(
        x.shape[-1] if valid_len is None else valid_len, jnp.int32)
    vlen_b = jnp.broadcast_to(vlen, x.shape[:1] if batched else (1,))
    from trackmaker_tpu.phy.spec_decode import (
        decode_capture_spec_jit, spec_supported_cfg)
    if spec_supported_cfg(cfg):
        xb = x if batched else x[None]
        res, ok = decode_capture_spec_jit(
            cfg, xb, local_addr, max_frames=max_frames, valid_len=vlen_b)
        ok = np.asarray(ok)
        if not ok.all():
            exact = _batched_fn(cfg, max_frames, False)(
                xb, local_addr, vlen_b)
            res = _merge_rows(ok, res, exact)
        return res if batched else jax.tree_util.tree_map(
            lambda a: a[0], res)
    if cfg.line_coding == MANCHESTER:
        if batched:
            return _batched_fn(cfg, max_frames, False)(
                x, local_addr, vlen_b)
        return decode_capture(cfg, x, local_addr, max_frames,
                              valid_len=vlen)

    if not batched:
        res, ok = decode_capture(cfg, x, local_addr, max_frames,
                                 valid_len=vlen, optimistic=True)
        if bool(ok):
            return res
        return decode_capture(cfg, x, local_addr, max_frames,
                              valid_len=vlen)

    res, ok = _batched_fn(cfg, max_frames, True)(x, local_addr, vlen_b)
    ok = np.asarray(ok)
    if ok.all():
        return res
    exact = _batched_fn(cfg, max_frames, False)(x, local_addr, vlen_b)
    return _merge_rows(ok, res, exact)


def _merge_rows(ok: np.ndarray, fast: DecodedFrames,
                exact: DecodedFrames) -> DecodedFrames:
    """Row-wise pick: `fast` where ok[b], else `exact`."""
    pick = jnp.asarray(ok)

    def merge(a, b):
        shape = (pick.shape[0],) + (1,) * (a.ndim - 1)
        return jnp.where(pick.reshape(shape), a, b)

    return jax.tree_util.tree_map(merge, fast, exact)


class PhyDecoder:
    """Host streaming facade with the reference's chunked-feed API.

    Buffers incoming sample chunks and runs the batched `decode_capture`
    over the accumulated tail whenever enough new data arrives.  For
    offline work prefer calling :func:`decode_capture` directly on whole
    recordings (vmapped over a batch).
    """

    def __init__(self, cfg: PhyConfig, local_addr: int,
                 max_frames_per_call: int = 64):
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frames = max_frames_per_call
        self._buf = np.zeros(0, dtype=np.float32)

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)

    @staticmethod
    def _bucket(n: int, min_bucket: int = 4096) -> int:
        b = min_bucket
        while b < n:
            b *= 2
        return b

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        min_need = self.cfg.preamble_len + self.cfg.header_samples
        if len(self._buf) < min_need:
            return []
        # decode everything we have; drop the searched prefix after.
        # buffers are zero-padded to power-of-2 buckets so jit compiles a
        # handful of shapes, with valid_len carrying the true length.
        n = len(self._buf)
        bucket = self._bucket(n)
        padded = np.zeros(bucket, np.float32)
        padded[:n] = self._buf
        res, searched = self._decode_with_cursor(jnp.asarray(padded), n)
        frames = res.to_frames()
        # drain the searched prefix even when nothing decoded — the
        # reference does this every call, keeping a preamble-1 overlap
        # (decoder.rs:89-109); without it a noise-only stream grows the
        # buffer without bound and re-decodes the same prefix (O(n^2)).
        drop = int(searched)
        if drop > 0:
            self._buf = self._buf[drop:]
        return frames

    def _decode_with_cursor(self, padded, n):
        """(frames, searched_until) — the speculative decoder when it
        covers this config (same cursor semantics), else the exact
        scan."""
        from trackmaker_tpu.phy.spec_decode import (
            decode_capture_spec_jit, spec_supported_cfg)
        if spec_supported_cfg(self.cfg):
            res, ok, searched, _cur = decode_capture_spec_jit(
                self.cfg, padded[None], self.local_addr,
                max_frames=self.max_frames, valid_len=n, with_cursor=True)
            if bool(np.asarray(ok)[0]):
                return (jax.tree_util.tree_map(lambda a: a[0], res),
                        searched[0])
        res, searched, _ = decode_capture(
            self.cfg, padded, self.local_addr,
            max_frames=self.max_frames, valid_len=n, with_cursor=True)
        return res, searched
