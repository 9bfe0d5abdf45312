"""chip_smoke.py: the GPU gate refuses the CPU, and every phase function
runs at reduced size on CPU devices (``main`` alone insists on a GPU)."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_gate_refuses_cpu(argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "GPU" in proc.stderr


def test_run_phase_prints_line_and_raises_on_failure(capsys):
    line = chip_smoke.run_phase("passes", lambda: {"ok": True, "x": 1})
    assert line["phase"] == "passes" and line["x"] == 1
    assert line["wall_s"] >= 0 and line["compile_s"] >= 0
    with pytest.raises(AssertionError, match="phase fails failed"):
        chip_smoke.run_phase("fails", lambda: {"ok": False})
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [p["phase"] for p in printed] == ["passes", "fails"]


def test_compile_clock_counts_nested_spans_once():
    clock = chip_smoke.CompileClock()
    clock("/jax/core/compile/jaxpr_trace_duration", 0.0, 4.0)
    clock("/jax/core/compile/jaxpr_trace_duration", 1.0, 2.0)  # nested jit
    clock("/jax/core/compile/backend_compile_duration", 3.0, 6.0)
    clock("/jax/core/compile/backend_compile_duration", 8.0, 9.0)
    clock("/jax/compilation_cache/cache_retrieval_time_sec", 8.0, 9.5)
    assert clock.seconds == 7.0


def test_phase_goldens_reduced():
    result = chip_smoke.run_phase("goldens", chip_smoke.phase_goldens, frames=1024)
    assert sorted(result["max_abs_err"]) == ["1", "2", "3", "4", "5", "6"]


def test_phase_flagship_reduced():
    result = chip_smoke.run_phase(
        "flagship", chip_smoke.phase_flagship, voices=4, seconds=0.1
    )
    assert result["frames"] == 4800 and result["pcm16_mismatches"] == 0
    assert result["rel_err"] <= chip_smoke.ORACLE_TOL


def test_phase_kit_reduced():
    result = chip_smoke.run_phase(
        "kit", chip_smoke.phase_kit, voices=4, seconds=0.05
    )
    assert result["frames"] == 2400
    assert result["rel_err"] <= chip_smoke.ORACLE_TOL


def test_phase_four_cards_on_virtual_cpu_devices():
    devices = jax.devices()[:4]
    assert len(devices) == 4
    result = chip_smoke.run_phase(
        "four_cards", chip_smoke.phase_four_cards, devices,
        c4_voices=4, c4_seconds=0.1, c5_voices=4, c5_seconds=0.05,
    )
    assert result["mesh"] == {"voice": 2, "part": 2}
    for case in ("config4", "config5"):
        assert result[case]["voice_sharded_stages"]
        assert result[case]["part_sharded_stages"]
        assert (
            result[case]["state_leaves_on_all_devices"]
            == result[case]["state_leaves"]
        )
    assert len(result["bytes_in_use"]) == 4
