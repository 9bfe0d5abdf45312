"""One entry point for every measurement probe: python -m benchmarks.probe <name>.

Probes are one-off experiments that each ask a specific performance
question; benchmarks/PROBES.md indexes them, and on a GPU each writes a JSON
artifact under benchmarks/results/ (benchmarks/artifacts.py). Run with no
arguments to list probes; arguments after the name pass through to the
probe's own CLI.

Measurement discipline shared by all probes: two-length scan differences
cancel the fixed per-call dispatch cost; scan carries must evolve or XLA
hoists the body; operands travel as arguments, not closures; every timing
ends in a wait on a value that depends on all the work.
"""

from __future__ import annotations

import runpy
import sys

PROBES = {
    "kernels-config5": (
        "kernels_config5",
        "config-5 hot-stage kernel variants (row gather, HRTF interp/DFT)",
    ),
    "unity-source-overhead": (
        "unity_source_overhead",
        "where the unity buffer-source group's step time goes",
    ),
    "conv-dft-chain": (
        "conv_dft_chain",
        "superblock convolver op-chain latency (transpose-free DFT)",
    ),
    "superblock-sweep": (
        "superblock_sweep",
        "config-5 xrt_compute vs superblock size",
    ),
    "biquad-scan-rounds": (
        "biquad_scan_rounds",
        "associative-scan round count vs first-order solve variants",
    ),
    "conv-subblock-dft": (
        "conv_subblock_dft",
        "sub-blocked batched-DFT partitioned convolution grain",
    ),
    "hrtf-dft-precision": (
        "hrtf_dft_precision",
        "HRTF DFT matmul precision (HIGHEST vs HIGH) vs oracle budget",
    ),
    "hrtf-stage-breakdown": (
        "hrtf_stage_breakdown",
        "HRTF stage decomposition: spectra interp vs OLA FIR",
    ),
    "hrir-interp-selection": (
        "hrir_interp_selection",
        "exact cheap-precision HRIR interp via {0,1} selection matmuls",
    ),
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "list"):
        print(__doc__)
        print("probes:")
        for name, (_mod, desc) in PROBES.items():
            print(f"  {name:24s} {desc}")
        return 0
    name = sys.argv[1]
    entry = PROBES.get(name)
    if entry is None:
        print(f"unknown probe {name!r}; run with no arguments to list",
              file=sys.stderr)
        return 2
    sys.argv = [f"benchmarks.probes.{entry[0]}"] + sys.argv[2:]
    runpy.run_module(f"benchmarks.probes.{entry[0]}", run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
