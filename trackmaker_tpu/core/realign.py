"""Gather-free dynamic window realignment.

Vmapped ``dynamic_slice`` with traced starts lowers to per-element
gathers, while row-gathers of 512-aligned rows move whole rows.  The
recipe: fetch 512-aligned rows with ``jnp.take``, then either mask
(for order-insensitive consumers) or realign exactly with
:func:`shift_realign`.

``shift_realign`` decomposes the shift ``s = 8a + b``: the lane part
``b`` is an 8-way select of STATIC shifts (exact — no arithmetic on
the values) and the row part ``a`` is a one-hot row matmul over
8-element rows — 64x fewer one-hot elements than a direct
[C, out, L] one-hot (whose materialization traffic dominates at these
shapes), and still exactly one 1.0 per output row, so the pick is
exact at HIGHEST precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shift_realign(src: jax.Array, s: jax.Array, out_len: int) -> jax.Array:
    """``out[c, k] = src[c, k + s[c]]`` exactly (f32-bit-identical).

    Out-of-range shifts (negative, or beyond ``src``'s last row)
    produce an all-zero one-hot -> zero rows, which callers arrange to
    be masked or unused.  Requires ``out_len % 8 == 0`` and
    ``src.shape[-1] % 8 == 0``."""
    c1, l = src.shape
    assert out_len % 8 == 0 and l % 8 == 0
    b = jnp.mod(s, 8)
    # a negative s in (-8, 0) would otherwise wrap its lane part (mod)
    # while the row part shifts by just one row, leaking src values —
    # force every negative shift to an all-zero one-hot
    a = jnp.where(s >= 0, jnp.floor_divide(s, 8), jnp.int32(-(2 ** 30)))
    acc = jnp.zeros_like(src)
    for i in range(8):
        sh_i = jnp.concatenate(
            [src[:, i:], jnp.zeros((c1, i), src.dtype)], axis=-1)
        acc = jnp.where((b == i)[:, None], sh_i, acc)
    rows = l // 8
    out_rows = out_len // 8
    src8 = acc.reshape(c1, rows, 8)
    ri = jnp.arange(out_rows, dtype=jnp.int32)[None, :, None]
    rj = jnp.arange(rows, dtype=jnp.int32)[None, None, :]
    sel = (rj == ri + a[:, None, None]).astype(src.dtype)
    return jnp.einsum("crk,ckj->crj", sel, src8,
                      precision=jax.lax.Precision.HIGHEST
                      ).reshape(c1, out_len)
