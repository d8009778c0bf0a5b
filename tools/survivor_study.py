"""Two-phase chem evaluation: survivor-rate + budget study.  Search metrics (evals, survivors, chem kernel volume) are
hardware-independent, so this runs on the CPU backend; wall clocks here
are NOT meaningful — device cost comes from tools/profile_lanes.py and
the bench on the GPU.

Run:
  XLA_FLAGS=--xla_force_host_platform_device_count=1 JAX_PLATFORMS=cpu \
  python tools/survivor_study.py [--quick]

Reports, per BO1 bench pair and chem_survivors budget S:
  evals        geometric bound evaluations (children expanded)
  surv         children surviving the geometric lb vs the incumbent
  surv%        surv / evals — the two-phase candidate fraction
  corners      chem corner kernel volume (lattice: 27 * trans_pop per
               lane-iteration; two-phase: 8 * S)
  err / conv   quality (must stay inside the reference epsilon band)
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="pair 1 + two synthetics only (pair 2 is ~3.4M "
                         "evals and takes minutes on CPU)")
    ap.add_argument("--mse", type=float, default=None,
                    help="override MSEThresh (e.g. 0.02 for a faster "
                         "pair-2 proxy)")
    args = ap.parse_args()

    import jax
    from goicp_tpu.bench import measure
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.search.device_engine import register_device

    cfg0 = measure.bench_shape(
        GoICPConfig.from_file(f"{measure.REF}/config.txt"))
    if args.mse is not None:
        cfg0 = dataclasses.replace(cfg0, MSEThresh=args.mse)

    pairs = measure.build_batch(cfg0, 4 if args.quick else 6)
    names = ["pair1", "pair2", "syn00", "syn01", "syn02", "syn03"]
    if args.quick:
        pairs = [pairs[0]] + pairs[2:]
        names = ["pair1", "syn00", "syn01"]

    budgets = [0, 8, 16, 24, 32, 64]
    print(f"{'pair':>6} {'S':>4} {'evals':>9} {'surv':>9} {'surv%':>6} "
          f"{'corners':>10} {'err':>9} {'conv':>5} {'outer':>6}")
    for name, pair in zip(names, pairs):
        for S in budgets:
            cfg = dataclasses.replace(cfg0, chem_survivors=S)
            t0 = time.time()
            r = jax.device_get(register_device(pair, cfg))
            dt = time.time() - t0
            ev = int(r.evals)
            sv = int(r.geom_surv)
            print(f"{name:>6} {S:>4} {ev:>9} {sv:>9} "
                  f"{100.0 * sv / max(ev, 1):>5.1f} "
                  f"{int(r.chem_corners):>10} {float(r.error):>9.4f} "
                  f"{str(bool(r.converged))[0]:>5} {int(r.outer_iters):>6}"
                  f"  [{dt:.1f}s]")


if __name__ == "__main__":
    main()
