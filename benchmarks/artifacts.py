"""Benchmark artifact writer: ONE implementation of the provenance rule.

An artifact is written only by a run on a GPU, and it records the device it
was measured on: JAX's platform, device kind and device count, and each
card's name and power limit as ``nvidia-smi`` reports them (a card set below
its maximum power runs slower under load). CPU runs never write one."""

import json
import os
import subprocess

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "results")


def clean_breakdown(bd: dict) -> dict:
    """Compress a RenderStats breakdown for a committed artifact: round
    floats, drop the verbose per-chunk lists. One shared implementation so
    bench.py and every probe emit the same artifact format."""
    return {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in bd.items()
        if not k.startswith("chunk_")
    }


def device_record() -> dict:
    """The devices this process runs on, with each card's name and power
    limit (one ``nvidia-smi`` line per card)."""
    import jax

    devices = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": smi.splitlines(),
    }


def write_artifact(name: str, results) -> bool:
    """Write results/<name>.json, with the device record, iff this process
    runs on a GPU. Returns True when written."""
    import jax

    if jax.devices()[0].platform != "gpu":
        return False
    record = {"device": device_record(), "results": results}
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, name + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    return True
