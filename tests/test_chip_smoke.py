"""chip_smoke.py's phases at tiny sizes on the CPU: every phase drives
its receiver through the public entry point and must report ok (the
same checks the script makes on the GPU at full size)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from trackmaker_tpu.core.config import FOUR_B_FIVE_B, PhyConfig  # noqa: E402

PHASES = {
    "xcorr": lambda tmp: chip_smoke.phase_xcorr(t=6000),
    "manchester": lambda tmp: chip_smoke.phase_line_coded(
        PhyConfig(), batch=2, n_frames=3, payload=16, n_oracle=2),
    "fourb5b": lambda tmp: chip_smoke.phase_line_coded(
        PhyConfig(line_coding=FOUR_B_FIVE_B), batch=2, n_frames=3,
        payload=16, n_oracle=2),
    "blocked": lambda tmp: chip_smoke.phase_blocked(
        seconds=1.5, n_blocks=4, n_frames=3),
    "cli": lambda tmp: chip_smoke.phase_cli(str(tmp), sizes=(200, 130, 20)),
    "ask": lambda tmp: chip_smoke.phase_ask(batch=2, n_frames=3,
                                            oracle_frames=2),
    "ofdm_v2": lambda tmp: chip_smoke.phase_ofdm_v2(batch=2, n_frames=2,
                                                    payload=16),
    "coded": lambda tmp: chip_smoke.phase_coded(batch=2, n_frames=2,
                                                payload=16),
    "ofdm_adaptive": lambda tmp: chip_smoke.phase_ofdm_adaptive(
        batch=2, n_frames=2, payload=16),
    "equalized": lambda tmp: chip_smoke.phase_equalized(
        batch=2, n_frames=3, payload=16),
    "sharded_blocked": lambda tmp: chip_smoke.phase_sharded_blocked(
        n_cards=4, seconds=1.5, n_blocks=4, n_frames=3),
    "dp_batch": lambda tmp: chip_smoke.phase_dp_batch(
        n_cards=4, batch=4, n_frames=3, payload=16),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_tiny(name, tmp_path):
    out = PHASES[name](tmp_path)
    assert out["ok"], out
    assert out["compile_s"] >= 0.0 and out["warm_s"] >= 0.0


def test_main_refuses_without_gpu(capsys, monkeypatch):
    """No GPU: non-zero exit and no JSON result line."""
    monkeypatch.setattr(chip_smoke, "_nvidia_smi", lambda: "fake, 700 W")
    monkeypatch.setattr(chip_smoke, "_chip_tests",
                        lambda: dict(ok=True, compile_s=0.0, warm_s=0.0))
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
