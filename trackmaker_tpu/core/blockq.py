"""Two-level block index for "first set bit >= cursor" queries.

A dense bool mask over a long capture answers repeated first-hit
queries (decoder candidate consumption, ASK update search, OFDM
preamble walk).  The naive form — ``argmax(mask & (idx >= cursor))``
per query — rescans the whole capture every scan step, and a global
``jnp.nonzero(size=N)`` compaction is a full sort-like pass per
capture.  The block form costs one reshape +
per-block ``any`` up front, then each query touches one `blk`-lane row
plus the block-any vector.
"""

from __future__ import annotations

import jax.numpy as jnp

_BIG = 2**30


def block_tables(mask, blk: int = 512):
    """mask bool[..., T] -> (blocks bool[..., HB, blk], any bool[..., HB])."""
    t = mask.shape[-1]
    hb = -(-t // blk)
    pad = [(0, 0)] * (mask.ndim - 1) + [(0, hb * blk - t)]
    blocks = jnp.pad(mask, pad).reshape(*mask.shape[:-1], hb, blk)
    return blocks, jnp.any(blocks, axis=-1)


def first_set_from(tables, cursor, blk: int = 512):
    """(first index >= cursor with mask set, exists) — unbatched tables."""
    blocks, block_any = tables
    hb = blocks.shape[0]
    lane = jnp.arange(blk, dtype=jnp.int32)
    brange = jnp.arange(hb, dtype=jnp.int32)
    c = jnp.clip(cursor, 0, hb * blk - 1)
    jb = c // blk
    off = c % blk
    row = blocks[jb]
    m1 = row & (lane >= off)
    has1 = jnp.any(m1)
    i1 = jb * blk + jnp.argmax(m1)
    m2 = block_any & (brange > jb)
    has2 = jnp.any(m2)
    b2 = jnp.argmax(m2)
    i2 = b2 * blk + jnp.argmax(blocks[b2])
    first = jnp.where(has1, i1, jnp.where(has2, i2, _BIG))
    return first.astype(jnp.int32), has1 | has2
