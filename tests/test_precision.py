"""Every matrix product and convolution on the main decode programs
runs at Precision.HIGHEST.

On a GPU an f32 dot or conv without an explicit precision may run in
TF32 (about three decimal digits), which could move a correlation
across the 0.9 detection threshold or flip a sync-refine argmax — a
different decision, not a faster one.  Each case lowers one jitted
program at a small shape and checks the StableHLO."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, PhyConfig

_OPS = re.compile(r"stablehlo\.(dot_general|convolution)\b")


def _programs():
    from trackmaker_tpu.dsp.equalizer import equalize_capture
    from trackmaker_tpu.parallel.stream import (
        _decode_blocked_jit, _decode_blocked_spec_jit)
    from trackmaker_tpu.phy import ask, ask_spec, ofdm
    from trackmaker_tpu.phy.coded import CodedManchesterPhy
    from trackmaker_tpu.phy.decoder import _batched_fn
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy
    from trackmaker_tpu.phy.ofdm_v2 import OfdmV2Config, demodulate_at_v2
    from trackmaker_tpu.phy.spec_decode import decode_capture_spec_jit

    man, fb = PhyConfig(), PhyConfig(line_coding=FOUR_B_FIVE_B)
    x = jax.ShapeDtypeStruct((2, 6000), jnp.float32)
    vl = jax.ShapeDtypeStruct((2,), jnp.int32)
    flat = jax.ShapeDtypeStruct((16384,), jnp.float32)
    ocfg = OfdmV2Config()
    acfg = ask.AskConfig()
    coded = CodedManchesterPhy(man, local_addr=2)
    adaptive = OfdmAdaptiveStreamPhy(local_addr=2)

    def eq_decode(xb):
        eq = jax.vmap(lambda r: equalize_capture(man, r)[0])(xb)
        return jax.vmap(lambda r: _batched_fn(man, 8, False)(
            r[None], 2, jnp.full((1,), r.shape[-1], jnp.int32)))(eq)

    return {
        "manchester_spec": lambda: jax.jit(
            lambda a: decode_capture_spec_jit(man, a, 2, max_frames=8)
        ).lower(x),
        "manchester_exact": lambda: _batched_fn(man, 8, False).lower(
            x, 2, vl),
        "fourb5b_spec": lambda: jax.jit(
            lambda a: decode_capture_spec_jit(fb, a, 2, max_frames=8)
        ).lower(x),
        "fourb5b_exact": lambda: _batched_fn(fb, 8, False).lower(x, 2, vl),
        "blocked_spec": lambda: _decode_blocked_spec_jit.lower(
            man, flat, 2, 4, 4, 16384, 32),
        "blocked_exact": lambda: _decode_blocked_jit.lower(
            man, flat, 2, 4, 4, 16384),
        "ask": lambda: ask_spec.demodulate_spec_jit.lower(
            acfg, jax.ShapeDtypeStruct((1, 20000), jnp.float32),
            max_frames=4),
        "ofdm_v2": lambda: jax.jit(jax.vmap(lambda rx: demodulate_at_v2(
            ocfg, rx, 8 * 23, ofdm.find_preambles(ocfg, rx, 2)))).lower(
                jax.ShapeDtypeStruct((2, 20000), jnp.float32)),
        "coded": lambda: jax.jit(coded.batched_decode_fn(2, 16)).lower(
            jax.ShapeDtypeStruct((2, 20000), jnp.float32)),
        "ofdm_adaptive": lambda: jax.jit(
            adaptive.batched_decode_fn(2, 16)).lower(
                jax.ShapeDtypeStruct((2, 30000), jnp.float32)),
        "equalized": lambda: jax.jit(eq_decode).lower(x),
    }


@pytest.mark.parametrize("name", sorted(_programs()))
def test_products_run_at_highest(name):
    text = _programs()[name]().as_text()
    ops = [ln for ln in text.splitlines() if _OPS.search(ln)]
    assert ops, f"{name}: no dot_general/convolution found"
    low = [ln.strip()[:200] for ln in ops if "HIGHEST" not in ln]
    assert not low, f"{name}: products below HIGHEST:\n" + "\n".join(low)
