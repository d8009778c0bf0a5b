"""Benchmark: BO1 registration throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} plus
the device it ran on (platform, device_kind, device count) and the card's
name and power limit as nvidia-smi reports them.

Baseline: the reference C++ binary registers BO1 pair 1 (2x86_3 -> 1eq2_6,
238 data points, DT 20^3, MSEThresh 0.01, regularization 0.0005,
ponderation 1) in 0.703125 s single-core (output/similar1.txt:1) =>
1.4222 pairs/s.  The measurement (goicp_tpu/bench/measure.py) runs the
cross-pair fused stream on a warmed DISTINCT-pair batch of 64 (the two
real golden pairs + synthetic pairs spanning the BO1 165-306-point size
range), with golden error/compat parity asserted inside, and a 32-pair
trimmed workload; both BASELINE.json metrics (pairs/s and bound-evals/s)
are reported in the one JSON line.

A measurement needs the GPU: without one this exits non-zero and prints
no number.  Usage:  python bench.py
"""

import json
import os
import sys

BASELINE_PAIRS_PER_S = 1.0 / 0.703125
HERE = os.path.dirname(os.path.abspath(__file__))


def _ref_rate(name: str):
    """Same-workload reference rate (pairs/s) from a checked-in file made by
    tools/ref_workload_baseline.py, or None."""
    try:
        with open(os.path.join(HERE, name)) as fh:
            ref = json.load(fh)
    except OSError:
        return None
    if ref.get("partial") or not ref.get("total_wall_s"):
        return None
    return ref["n_pairs"] / ref["total_wall_s"]


def main() -> int:
    from goicp_tpu.utils.device import card_name_and_power_limit, \
        device_summary
    dev = device_summary()
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev}", file=sys.stderr)
        return 1
    from goicp_tpu.bench.measure import measure
    r = measure()

    v = r["pairs_per_s"]
    base = _ref_rate("REF_BASELINE_WORKLOAD.json")
    base_kind = "ref_O3_same_workload"
    if base is None:
        base, base_kind = BASELINE_PAIRS_PER_S, "pair1_artifact_0.703s"
    line = {
        "metric": "bo1_registration_throughput_1chip",
        "value": v,
        "unit": "pairs/s",
        "vs_baseline": v / base,
        "baseline": base_kind,
        "vs_pair1_artifact": v / BASELINE_PAIRS_PER_S,
        "bound_evals_per_s": r["bound_evals_per_s"],
        "distinct_pairs": r["batch"],
        "trimmed_pairs_per_s": r["trimmed_pairs_per_s"],
    }
    tbase = _ref_rate("REF_BASELINE_TRIMMED.json")
    if tbase is not None:
        line["trimmed_vs_baseline"] = r["trimmed_pairs_per_s"] / tbase
    line.update(platform=dev["platform"], device_kind=dev["kind"],
                device_count=dev["count"],
                card=card_name_and_power_limit())
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
