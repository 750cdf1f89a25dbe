"""Sharded long-capture OFDM decode over a device mesh.

The OFDM families (v2 / adaptive) have no consumption coupling between
frames — each frame is located by its normalized chirp correlation and
demodulated independently — so the sharded decode is a SINGLE pass
(contrast `parallel/stream.py`'s consumed-until fixpoint for the
line-coded PHY): split the capture into one block per shard, pull the
right neighbor's head as a halo wide enough to finish any
frame that starts inside the owned block, find + demodulate per shard,
and keep exactly the frames whose preamble starts in the owned region.
A frame straddling a shard boundary is decoded (fully) by the shard
that owns its first sample and by no one else.

Beyond-parity capability: the reference has no OFDM at all; the
sharding pattern mirrors `parallel/stream.py:decode_blocked_sharded`
(mesh mechanics, ppermute halo, ownership masking).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy.ofdm import find_preambles
from trackmaker_tpu.phy.ofdm_v2 import OfdmV2Config, demodulate_at_v2


def _demod_fn(cfg: OfdmV2Config):
    """Adaptive configs demodulate with the loading-aware demapper."""
    from trackmaker_tpu.phy.ofdm_adaptive import (OfdmAdaptiveConfig,
                                                  demodulate_at_adaptive)
    if isinstance(cfg, OfdmAdaptiveConfig):
        return demodulate_at_adaptive
    return demodulate_at_v2


def ofdm_halo_size(cfg: OfdmV2Config, n_bits: int) -> int:
    """Samples a shard needs past its block to finish a frame whose
    preamble starts on the last owned sample (+ SC-search slack)."""
    return cfg.frame_samples(n_bits) + cfg.preamble_len + 64


def decode_ofdm_blocked_sharded(
    cfg: OfdmV2Config,
    capture,                    # f32[T] one long capture
    frame_bytes_len: int,       # equal-length frames (bulk transfer)
    mesh: Mesh,
    max_frames_per_block: int = 16,
) -> list[Frame]:
    """Decode one long capture of equal-length OFDM frames sharded over
    the mesh (dp x sp fold into one ring, like the line-coded path).

    Frames are returned in capture order, CRC-verified
    (`Frame.from_bits`).  Falls back to the single-device path when the
    per-shard block is smaller than the halo (capture too short to be
    worth sharding)."""
    n_bits = frame_bytes_len * 8
    x = jnp.asarray(capture, jnp.float32)
    t = x.shape[-1]
    n_shards = int(np.prod(list(mesh.shape.values())))
    halo = ofdm_halo_size(cfg, n_bits)
    block = -(-t // n_shards)
    if block < halo or n_shards == 1:
        starts = np.asarray(find_preambles(
            cfg, x, max_frames_per_block * max(n_shards, 1)))
        starts = starts[starts >= 0]
        if len(starts) == 0:
            return []
        bits = np.asarray(_demod_fn(cfg)(
            cfg, x, n_bits, jnp.asarray(starts)))
        return [f for row in bits
                if (f := Frame.from_bits(row)) is not None]

    x = jnp.pad(x, (0, block * n_shards - t))
    blocks = x.reshape(n_shards, block)
    flat_mesh = Mesh(mesh.devices.reshape(-1), axis_names=("sp",))
    spec = P("sp", None)
    demod = _demod_fn(cfg)
    k = max_frames_per_block

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=flat_mesh, in_specs=spec,
        out_specs=(P("sp", None, None), P("sp", None)))
    def run(xb):                       # xb: [1, block] per shard
        nsp = jax.lax.axis_size("sp")
        idx = jax.lax.axis_index("sp")
        edge = xb[:, :halo]
        right = jax.lax.ppermute(
            edge, "sp", [((i + 1) % nsp, i) for i in range(nsp)])
        right = jnp.where(idx < nsp - 1, right, 0.0)
        ext = jnp.concatenate([xb, right], axis=1)[0]
        starts = find_preambles(cfg, ext, k)
        # ownership: the shard whose block holds the preamble start
        # decodes the frame; halo-region hits belong to the neighbor
        mine = (starts >= 0) & (starts < block)
        bits = demod(cfg, ext, n_bits, jnp.where(mine, starts, 0))
        gstart = jnp.where(mine, idx * block + starts, -1)
        return bits[None], gstart[None]

    bits, gstarts = run(blocks)
    bits = np.asarray(bits).reshape(-1, n_bits)
    gstarts = np.asarray(gstarts).reshape(-1)
    out = []
    for i in np.argsort(gstarts):
        if gstarts[i] < 0:
            continue
        f = Frame.from_bits(bits[i])
        if f is not None:
            out.append(f)
    return out
