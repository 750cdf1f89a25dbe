"""Sequence-parallel decode of long captures: time blocks + halo exchange.

The reference's streaming decoder keeps a preamble-length-1 overlap
between chunks so detections never straddle a boundary
(src/phy/decoder.rs:89-109).  Sharding a capture's *time* axis across
devices needs the same overlap arithmetic, device-to-device: every shard
pulls a halo (one max-size frame + preamble + sync margin) from its right
neighbor with ``ppermute`` and decodes its extended block
locally, attempting exactly the candidates whose preamble starts inside
its own region (``scan_limit``).

Ownership alone is NOT equivalent to sequential consumption: a frame
near the seam whose *payload* embeds preamble bytes can consume into the
next block's region, suppressing candidates there that the next shard —
scanning from its own start — would otherwise attempt (and possibly
decode as a valid frame the sequential walk never emits).  The fix is a
**consumed-until fixpoint**: each shard reports its final consumption
cursor; the right neighbor restarts its walk at that intrusion point
(``start_cursor``) and re-decodes; iterate until no cursor changes.
Each shard converges once its left neighbor has, so the loop terminates
in <= n_shards iterations — in practice 1 extra decode only when a
frame actually straddles a seam.  Blocks smaller than the halo are fine:
an intrusion reaching past the immediate neighbor propagates through it
on the next iteration (a shard whose start_cursor exceeds its
scan_limit attempts nothing and forwards the endpoint unchanged).  With the fixpoint converged the
per-block walks stitch into exactly the sequential cursor walk, so
blocked == sequential decode decision-for-decision
(tests/test_parallel_adversarial.py).

This is the blockwise/"long-context" treatment of unbounded sample
streams; the same function handles one long recording on one device by
folding blocks into the batch axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.phy.decoder import DecodedFrames, decode_capture


def halo_size(cfg: PhyConfig) -> int:
    return (cfg.preamble_len + cfg.max_frame_samples
            + cfg.sync_margin + cfg.sync_len + 8)


def _mask_mine(res: DecodedFrames, block: int, gstart_base) -> DecodedFrames:
    """Keep frames whose preamble starts inside the shard's own region,
    rebasing starts to global indices."""
    mine = res.valid & (res.start >= 0) & (res.start < block)
    gstart = jnp.where(mine, res.start + gstart_base, -1)
    return res._replace(
        valid=mine,
        start=gstart,
        frame_bytes=jnp.where(
            mine[..., None], res.frame_bytes, 0).astype(jnp.uint8),
        length=jnp.where(mine, res.length, 0),
        frame_type=jnp.where(mine, res.frame_type, 0),
        sequence=jnp.where(mine, res.sequence, 0),
        src=jnp.where(mine, res.src, 0),
        dst=jnp.where(mine, res.dst, 0),
        corr=jnp.where(mine, res.corr, 0.0),
    )


def _sharded_spec_run(cfg, blocks, local_addr, flat_mesh, t, block,
                      max_frames_per_block, n_cand):
    """shard_map body for the speculative sharded decode: phase A
    (correlation + attempts + epilogue, phy/spec_decode.py) runs ONCE
    per shard; the consumed-until seam fixpoint re-runs only the walk,
    passing consumption endpoints around the `sp` ring with ppermute —
    the multi-device analogue of `_decode_blocked_spec`.

    Returns ``(frames[n_shards, K], ok[n_shards])``; any False in `ok`
    (candidate overflow / 4B5B conformance flag on an attempted
    candidate) means the caller must fall back to the exact scan path.
    Correctness argument: identical to `_decode_blocked_spec` — the walk
    over exact per-candidate fields converges left-to-right to the
    sequential cursor walk (module docstring)."""
    from trackmaker_tpu.phy.spec_decode import (
        _spec_compact, _spec_phase_a, _spec_walk_prepare,
        _spec_walk_query)

    halo = halo_size(cfg)
    spec = P("sp", None)
    out_struct = jax.tree_util.tree_map(lambda _: spec, _out_struct())

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=flat_mesh, in_specs=spec,
        out_specs=(out_struct, P("sp")))
    def run(xb):                       # xb: [1, block] per shard
        nsp = jax.lax.axis_size("sp")
        idx = jax.lax.axis_index("sp")
        edge = xb[:, :halo]
        right_halo = jax.lax.ppermute(
            edge, "sp", [((i + 1) % nsp, i) for i in range(nsp)])
        right_halo = jnp.where(idx < nsp - 1, right_halo, 0.0)
        ext = jnp.concatenate([xb, right_halo], axis=1)  # [1, block+halo]
        vlen = jnp.where(idx < nsp - 1, block + halo, t - idx * block)
        vlens = jnp.reshape(vlen, (1,)).astype(jnp.int32)

        a = _spec_phase_a(cfg, ext, jnp.asarray(local_addr, jnp.int32),
                          n_cand, vlens)
        limit = (vlens * 0 + block).astype(jnp.int32)
        prep = _spec_walk_prepare(a.fields, limit, max_frames_per_block)

        def walk(cur):
            keep, att, fcur, _done, _pend = _spec_walk_query(
                prep, cur, max_frames_per_block)
            return keep, att, fcur

        cur0 = (vlens * 0).astype(jnp.int32)
        keep0, att0, fcur0 = walk(cur0)

        def propose(fcur):
            e = jnp.reshape(idx * block, (1,)) + fcur  # global endpoint
            e_left = jax.lax.ppermute(
                e, "sp", [(i, (i + 1) % nsp) for i in range(nsp)])
            nc = jnp.where(idx == 0, 0,
                           jnp.maximum(e_left - idx * block, 0))
            return nc.astype(jnp.int32)

        def cond(state):
            return state[4]

        def body(state):
            cur, keep, att, fcur, _go = state
            nc = propose(fcur)
            go = jax.lax.psum(
                jnp.sum((nc != cur).astype(jnp.int32)), "sp") > 0
            keep2, att2, fcur2 = jax.lax.cond(
                go, lambda: walk(nc), lambda: (keep, att, fcur))
            return (jnp.where(go, nc, cur), keep2, att2, fcur2, go)

        _cur, keep, att, _fcur, _ = jax.lax.while_loop(
            cond, body, (cur0, keep0, att0, fcur0, jnp.asarray(True)))

        res = _spec_compact(a, keep, max_frames_per_block)
        res = _mask_mine(res, block, idx * block)
        ok = ~(a.overflow | jnp.any(att & a.nonconf, axis=-1))  # [1]
        return res, ok

    return run(blocks)


def decode_blocked_sharded(
    cfg: PhyConfig,
    capture,                    # f32[T] single long capture
    local_addr: int,
    mesh: Mesh,
    max_frames_per_block: int = 32,
    n_cand: int = 128,
    use_spec: bool | None = None,
) -> DecodedFrames:
    """Decode one long capture sharded over the mesh's `sp` axis (and the
    `dp` axis too — blocks fold over both, dp*sp shards total).

    Returns DecodedFrames with [n_blocks * K] slots and *global* start
    indices.

    Configurations the speculative decoder covers route the per-shard
    decode through it (`_sharded_spec_run`), falling back to the exact
    scan path when any shard overflows its candidate table or trips a
    4B5B conformance flag.  ``use_spec=False`` forces the exact path
    (the reference the tests compare the speculative one against).
    """
    x = jnp.asarray(capture, jnp.float32)
    t = x.shape[-1]
    n_shards = mesh.shape["dp"] * mesh.shape["sp"]
    halo = halo_size(cfg)
    block = -(-t // n_shards)
    t_pad = block * n_shards
    x = jnp.pad(x, (0, t_pad - t))
    blocks = x.reshape(n_shards, block)

    flat_mesh = Mesh(mesh.devices.reshape(-1), axis_names=("sp",))
    spec = P("sp", None)

    from trackmaker_tpu.phy.spec_decode import spec_supported_cfg
    if use_spec is None:
        use_spec = spec_supported_cfg(cfg)
    if use_spec and spec_supported_cfg(cfg):
        out, ok = _sharded_spec_run(
            cfg, blocks, local_addr, flat_mesh, t, block,
            max_frames_per_block, n_cand)
        if bool(np.asarray(ok).all()):
            return jax.tree_util.tree_map(
                lambda a: a.reshape((-1,) + a.shape[2:]), out)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=flat_mesh, in_specs=spec,
        out_specs=jax.tree_util.tree_map(lambda _: spec, _out_struct()))
    def run(xb):                       # xb: [1, block] per shard
        nsp = jax.lax.axis_size("sp")
        idx = jax.lax.axis_index("sp")
        # pull left edge of right neighbor as our halo (ppermute)
        edge = xb[:, :halo]
        right_halo = jax.lax.ppermute(
            edge, "sp", [((i + 1) % nsp, i) for i in range(nsp)])
        # last shard has no right neighbor: zeros
        right_halo = jnp.where(idx < nsp - 1, right_halo, 0.0)
        ext = jnp.concatenate([xb, right_halo], axis=1)  # [1, block+halo]
        vlen = jnp.where(idx < nsp - 1, block + halo, t - idx * block)

        def decode(cur0):
            res, _s, fcur = decode_capture(
                cfg, ext[0], local_addr,
                max_frames=max_frames_per_block,
                valid_len=vlen, with_cursor=True,
                start_cursor=cur0, scan_limit=block)
            return res, fcur

        cur0 = (vlen * 0).astype(jnp.int32)
        res0, fcur0 = decode(cur0)

        # consumed-until fixpoint over the sp ring: pass each shard's
        # global consumption endpoint right; restart the neighbor's walk
        # at the intrusion point; loop while any shard's cursor moved.
        def propose(cur, fcur):
            e = jnp.reshape(idx * block + fcur, (1,))  # global endpoint
            e_left = jax.lax.ppermute(
                e, "sp", [(i, (i + 1) % nsp) for i in range(nsp)])[0]
            nc = jnp.where(idx == 0, 0,
                           jnp.maximum(e_left - idx * block, 0))
            return nc.astype(jnp.int32)

        def cond(state):
            return state[3]

        def body(state):
            cur, res, fcur, _go = state
            nc = propose(cur, fcur)
            go = jax.lax.psum(
                (nc != cur).astype(jnp.int32), "sp") > 0  # uniform
            res2, fcur2 = jax.lax.cond(
                go, lambda: decode(nc), lambda: (res, fcur))
            return (jnp.where(go, nc, cur), res2, fcur2, go)

        cur, res, fcur, _ = jax.lax.while_loop(
            cond, body, (cur0, res0, fcur0, jnp.asarray(True)))

        out = _mask_mine(res, block, idx * block)
        return jax.tree_util.tree_map(lambda a: a[None], out)

    out = run(blocks)
    # flatten [n_shards, K] -> [n_shards*K]
    return jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), out)


def _out_struct():
    # any DecodedFrames-shaped pytree (used only for out_specs mapping)
    z = np.zeros(1)
    return DecodedFrames(z, z, z, z, z, z, z, z, z)


def _overlapping_blocks(x, t: int, n_blocks: int, block: int, halo: int):
    """[n_blocks, block+halo] overlapping windows of x (length t) via
    shifted reshapes instead of a general gather (the windows are just a
    reshape of the base blocks plus halo columns sliced from
    ceil(halo/block) shifted copies)."""
    nxtra = -(-halo // block)
    xp = jnp.pad(x, (0, block * (n_blocks + nxtra) - t))
    parts = [xp[: n_blocks * block].reshape(n_blocks, block)]
    got, j = 0, 0
    while got < halo:
        take = min(block, halo - got)
        y = xp[(j + 1) * block: (j + 1 + n_blocks) * block]
        parts.append(y.reshape(n_blocks, block)[:, :take])
        got += take
        j += 1
    return jnp.concatenate(parts, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_blocks", "max_frames_per_block", "t"))
def _decode_blocked_jit(cfg, x, local_addr, n_blocks,
                        max_frames_per_block, t):
    halo = halo_size(cfg)
    block = -(-t // n_blocks)
    starts = jnp.arange(n_blocks, dtype=jnp.int32) * block
    wins = _overlapping_blocks(x, t, n_blocks, block, halo)
    vlens = jnp.minimum(block + halo, t - starts)

    def decode(cursors):
        res, _s, fcur = jax.vmap(
            lambda w, v, c: decode_capture(
                cfg, w, local_addr, max_frames=max_frames_per_block,
                valid_len=v, with_cursor=True, start_cursor=c,
                scan_limit=block))(wins, vlens, cursors)
        return res, fcur

    cur0 = jnp.zeros(n_blocks, jnp.int32)
    res0, fcur0 = decode(cur0)

    # same consumed-until fixpoint as the sharded path, in-batch
    def propose(fcur):
        e = starts + fcur
        nxt = jnp.maximum(e[:-1] - starts[1:], 0).astype(jnp.int32)
        return jnp.concatenate([jnp.zeros(1, jnp.int32), nxt])

    def cond(state):
        cur, _res, fcur = state
        return jnp.any(propose(fcur) != cur)

    def body(state):
        cur, _res, fcur = state
        nc = propose(fcur)
        res2, fcur2 = decode(nc)
        return (nc, res2, fcur2)

    _cur, res, _fcur = jax.lax.while_loop(
        cond, body, (cur0, res0, fcur0))

    out = _mask_mine(res, block, starts[:, None])
    return jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), out)


def _decode_blocked_spec(cfg, x, local_addr, n_blocks,
                         max_frames_per_block, t, n_cand):
    """Blockwise decode through the speculative decoder, FLAT: the
    capture is correlated ONCE as one stream (no halo duplication, no
    (n_blocks, block+halo) windowed copy), the per-128-lag hit rows
    reshape into per-block candidate tables with GLOBAL positions, and
    every attempt reads its window straight from the single shared
    buffer — a frame near a block seam just reads the following
    samples.  Blocks exist only for the walk: per-block cursors/limits
    are global sample positions, and the consumed-until seam fixpoint
    re-runs only the walk until cursors converge.

    Returns ``(frames, ok)``; `ok=False` (candidate-table overflow or a
    4B5B conformance flag on an *attempted* candidate in the converged
    walk) means the caller must fall back to the exact blocked path.
    Conformance gates on the FINAL walk's attempted set: block 0's walk
    never depends on a cursor, so by left-to-right induction a
    converged fixpoint whose final walks are all conformant reproduces
    the sequential cursor walk exactly (same argument as the module
    docstring, with 'decode' = 'walk over exact per-candidate fields')."""
    from trackmaker_tpu.phy.spec_decode import (
        _spec_compact, _spec_phase_a, _spec_walk_prepare,
        _spec_walk_query)

    block = -(-(-(-t // n_blocks)) // 128) * 128   # multiple of 128
    t_pad = n_blocks * block
    xf = jnp.pad(jnp.asarray(x, jnp.float32), (0, t_pad - t))
    starts = jnp.arange(n_blocks, dtype=jnp.int32) * block
    vlens = jnp.full((n_blocks,), t, jnp.int32)

    a = _spec_phase_a(cfg, xf, jnp.asarray(local_addr, jnp.int32),
                      n_cand, vlens, flat_blocks=(n_blocks, block))
    limit = starts + block
    prep = _spec_walk_prepare(a.fields, limit, max_frames_per_block)

    def walk(cur):
        keep, att, fcur, _done, _pend = _spec_walk_query(
            prep, cur, max_frames_per_block)
        return keep, att, fcur

    cur0 = starts
    keep0, att0, fcur0 = walk(cur0)

    def propose(fcur):
        # global intrusion endpoint from the left neighbor, clamped to
        # the block's own start
        nxt = jnp.maximum(fcur[:-1], starts[1:]).astype(jnp.int32)
        return jnp.concatenate([jnp.zeros(1, jnp.int32), nxt])

    def cond(state):
        cur, _k, _a, fcur = state
        return jnp.any(propose(fcur) != cur)

    def body(state):
        cur, _k, _a, fcur = state
        nc = propose(fcur)
        k2, a2, f2 = walk(nc)
        return (nc, k2, a2, f2)

    _cur, keep, att, _f = jax.lax.while_loop(
        cond, body, (cur0, keep0, att0, fcur0))

    res = _spec_compact(a, keep, max_frames_per_block)
    # starts are already global; ownership is by construction (block
    # b's candidate table only holds positions inside block b), so no
    # rebase — just re-assert the valid mask shape
    ok = jnp.all(~(a.overflow | jnp.any(att & a.nonconf, axis=-1)))
    flat = jax.tree_util.tree_map(
        lambda arr: arr.reshape((-1,) + arr.shape[2:]), res)
    return flat, ok


_decode_blocked_spec_jit = jax.jit(
    _decode_blocked_spec,
    static_argnames=("cfg", "n_blocks", "max_frames_per_block", "t",
                     "n_cand"))


def decode_blocked_single_chip(
    cfg: PhyConfig,
    capture,
    local_addr: int,
    n_blocks: int,
    max_frames_per_block: int = 32,
    n_cand: int = 128,
) -> DecodedFrames:
    """Same blockwise decomposition on one device — the batched form
    for very long captures (fully jitted; pass a device-resident array
    to avoid re-uploading the capture).

    Configurations the speculative decoder covers route through it
    (`_decode_blocked_spec`), falling back to the exact scan path when
    any block overflows its candidate table or trips a 4B5B
    conformance flag."""
    x = jnp.asarray(capture, jnp.float32)
    t = int(x.shape[-1])
    from trackmaker_tpu.phy.spec_decode import spec_supported_cfg
    if spec_supported_cfg(cfg):
        res, ok = _decode_blocked_spec_jit(
            cfg, x, local_addr, n_blocks, max_frames_per_block, t, n_cand)
        if bool(np.asarray(ok)):
            return res
    return _decode_blocked_jit(cfg, x, local_addr, n_blocks,
                               max_frames_per_block, t)
