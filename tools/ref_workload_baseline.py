"""Measure the reference C++ binary on the bench's OWN 64-pair workload.

The headline bench (goicp_tpu/bench/measure.py) registers a distinct-pair
batch: the two real BO1 golden pairs + synthetic pairs spanning the BO1
size envelope.  Comparing that honest mixed workload against the
reference's checked-in pair-1-only artifact (0.703 s for the EASIEST pair)
is meaningless in both directions — so this tool runs the reference binary
(/root/reference/GoICP, the single-threaded C++ the repo re-designs) over
the IDENTICAL pool and records per-pair wall times.

Workload identity: synthetic pairs come from bench.measure.synthetic_pool
(same seed) as RAW clouds; they are written here as .mol2 (atom names carry
the property codes) and the binary runs its own centralize + common-scale
+ 6-sig-digit file round-trip (jly_main.cpp:72-99) — the same normalized
problem the engine solves, since measure.build_batch applies the
identical normalize+quantize path to the same raw clouds.

Per-pair cap: a pair that exceeds --cap seconds is recorded AT the cap
(the reference's true wall is higher), which under-states the reference
total and therefore under-states our vs_baseline — conservative.

Output: REF_BASELINE_WORKLOAD.json at the repo root; bench.py uses it as
the primary vs_baseline denominator (pairs/s of the reference on the same
workload, same machine).

Usage:  python tools/ref_workload_baseline.py [--cap 60] [--n 64]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REF = "/root/reference"
SCRATCH = os.path.join(REPO, ".refbase")

from goicp_tpu.bench.measure import BATCH, synthetic_pool  # noqa: E402
from goicp_tpu.io.mol2 import write_mol2 as _write_mol2       # noqa: E402


def _write_cfpfh(path: str, n: int) -> None:
    row = " ".join(["0.0"] * 41) + "\n"
    with open(path, "w") as fh:
        fh.writelines([row] * n)


def _prepare_scratch(pool):
    for d in ("cavities", "cavitiesN", "cfpfh", "output"):
        os.makedirs(os.path.join(SCRATCH, d), exist_ok=True)
    shutil.copy(os.path.join(REF, "config.txt"),
                os.path.join(SCRATCH, "config.txt"))
    # rebuild the reference at -O3 UNCONDITIONALLY (the checked-in binary
    # is ~8x slower; and a stale scratch binary/cloud set could silently
    # diverge from the current reference sources or pool seed)
    binpath = os.path.join(SCRATCH, "GoICP")
    srcs = [os.path.join(REF, f) for f in
            ("jly_main.cpp", "jly_goicp.cpp", "jly_3ddt.cpp",
             "matrix.cpp", "transformation.cpp", "ConfigMap.cpp",
             "StringTokenizer.cpp")]
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                    "-o", binpath] + srcs,
                   check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    for cav in ("2x86_3", "1eq2_6", "2ktd_1", "4imo_2"):
        for sub, ext in (("cavities", ".mol2"), ("cfpfh", ".cfpfh")):
            dst = os.path.join(SCRATCH, sub, f"{cav}_cavity6{ext}")
            if not os.path.exists(dst):
                os.symlink(os.path.join(REF, sub, f"{cav}_cavity6{ext}"),
                           dst)
    for name, data, model, dp, mp in pool:
        _write_mol2(os.path.join(SCRATCH, "cavities",
                                 f"{name}d_cavity6.mol2"), data, dp)
        _write_mol2(os.path.join(SCRATCH, "cavities",
                                 f"{name}m_cavity6.mol2"), model, mp)
        _write_cfpfh(os.path.join(SCRATCH, "cfpfh",
                                  f"{name}d_cavity6.cfpfh"), len(data))
        _write_cfpfh(os.path.join(SCRATCH, "cfpfh",
                                  f"{name}m_cavity6.cfpfh"), len(model))


def _run_pair(k: int, model_name: str, data_name: str, nd: int,
              cap: float, config_name: str = "config.txt"):
    """One reference registration; returns (wall_s, reg_s, capped, rc).

    wall_s is the full process wall; reg_s is the registration-only time
    the binary itself reports in output/p{k}.txt (clock around Register(),
    jly_main.cpp:108-123) — the fair comparator against the engine's
    warmed registration-only wall (the process wall carries ~0.06 s
    of parse/DT/IO overhead per pair).  Falls back to wall for capped
    runs (conservative: caps under-state the reference's true time)."""
    cmd = ["timeout", str(cap), os.path.join(SCRATCH, "GoICP"),
           f"cavities/{model_name}_cavity6.mol2",
           f"cavities/{data_name}_cavity6.mol2",
           str(nd), config_name, f"output/p{k}.txt", str(k)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=SCRATCH, stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    wall = time.time() - t0
    capped = proc.returncode == 124
    wall = cap if capped else wall
    reg = wall
    if not capped:
        try:
            with open(os.path.join(SCRATCH, "output", f"p{k}.txt")) as fh:
                first = fh.readline().strip()
            if first.startswith("Time:"):
                reg = float(first.split(":", 1)[1])
        except (OSError, ValueError):
            pass
    return wall, reg, capped, proc.returncode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cap", type=float, default=60.0)
    ap.add_argument("--n", type=int, default=BATCH)
    ap.add_argument("--trimmed", action="store_true",
                    help="measure the TRIMMED dissimilar-style workload "
                         "(noisy/outlier pool, trimFraction=0.1 — "
                         "BASELINE.json config 4; reference trim "
                         "semantics jly_goicp.cpp:384-390) -> "
                         "REF_BASELINE_TRIMMED.json")
    args = ap.parse_args()

    if args.trimmed:
        from goicp_tpu.bench.measure import (TRIM_BATCH, TRIM_FRACTION,
                                             synthetic_pool_trimmed)
        if args.n == BATCH:
            args.n = TRIM_BATCH
        pool = synthetic_pool_trimmed(args.n)
        _prepare_scratch(pool)
        # reference config with trimming enabled, same everything else
        cfgp = os.path.join(SCRATCH, "config_trim.txt")
        with open(os.path.join(REF, "config.txt")) as fh:
            lines = fh.readlines()
        with open(cfgp, "w") as fh:
            for ln in lines:
                if ln.strip().startswith("trimFraction"):
                    ln = f"trimFraction={TRIM_FRACTION}\n"
                fh.write(ln)
        jobs = [(f"{name}m", f"{name}d", len(data))
                for name, data, model, dp, mp in pool]
        config_name = "config_trim.txt"
    else:
        pool = synthetic_pool(args.n - 2)
        _prepare_scratch(pool)
        # same pool composition as measure.build_batch, same order
        jobs = [("1eq2_6", "2x86_3", 238),    # BO1 pair 1 (model, data, Nd)
                ("4imo_2", "2ktd_1", 247)]    # BO1 pair 2
        jobs += [(f"{name}m", f"{name}d", len(data))
                 for name, data, model, dp, mp in pool]
        config_name = "config.txt"

    rows = []
    total = 0.0
    total_reg = 0.0
    for k, (mname, dname, nd) in enumerate(jobs):
        wall, reg, capped, rc = _run_pair(k, mname, dname, nd, args.cap,
                                          config_name)
        total += wall
        total_reg += reg
        rows.append({"pair": f"{dname}->{mname}", "nd": nd,
                     "wall_s": round(wall, 3), "reg_s": round(reg, 4),
                     "capped": capped, "rc": rc})
        print(f"[{k + 1}/{len(jobs)}] {dname}->{mname} nd={nd} "
              f"wall={wall:.2f}s reg={reg:.2f}s capped={capped} rc={rc} "
              f"(running total {total:.1f}s)", flush=True)
        # incremental write so a partial run is still inspectable
        _dump(rows, total, total_reg, args, partial=(k + 1 < len(jobs)))
    print(f"TOTAL {total:.1f}s process / {total_reg:.1f}s registration "
          f"for {len(jobs)} pairs = {len(jobs) / total_reg:.4f} pairs/s "
          f"(registration-only)")


def _dump(rows, total, total_reg, args, partial: bool):
    trimmed = getattr(args, "trimmed", False)
    out = {
        "description": "reference C++ binary (single core, this machine) "
                       "on the bench's own "
                       + ("TRIMMED noisy/outlier workload"
                          if trimmed else "distinct-pair workload"),
        "binary": os.path.join(REF, "GoICP"),
        "config": "reference config.txt (MSEThresh 0.01, reg 0.0005, "
                  "ponderation 1, DT 20^3)",
        "cap_s": args.cap,
        "n_pairs": len(rows),
        "partial": partial,
        # total_wall_s is the fair denominator vs the engine's warmed
        # registration-only wall: the binary's own Register() clock
        # (process wall incl. parse/DT/IO kept in total_process_s)
        "total_wall_s": round(total_reg, 3),
        "total_process_s": round(total, 3),
        "pairs_per_s": round(len(rows) / total_reg, 5) if total_reg
        else 0.0,
        "n_capped": sum(r["capped"] for r in rows),
        "pairs": rows,
    }
    name = "REF_BASELINE_TRIMMED.json" if trimmed \
        else "REF_BASELINE_WORKLOAD.json"
    with open(os.path.join(REPO, name), "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
