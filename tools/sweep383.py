"""Full-scale BO1-sized sweep: 383 pairs end-to-end through the fused
stream engine, with JSONL output, checkpoint/resume, and an optional
mid-run kill to prove resume at scale.

The reference sweeps 383 similar pairs (bo1_GoICP.py:40-54, one process
per pair) and carries the 383-pair dissimilar TSV for the trimmed
workload (the disabled loop at bo1_GoICP.py:56-68 + trimFraction,
READMEGo-ICP.md:82-84).  Only 2 real BO1 pairs ship with the repo, so
the similar pool is the two real golden pairs + 381 synthetic pairs in
the BO1 size envelope (bench.measure.synthetic_pool semantics, larger
draw); --trimmed switches to 383 noisy/outlier pairs registered with
trimFraction=0.1 (bench.measure.synthetic_pool_trimmed semantics) —
the dissimilar-style workload class at full dataset scale.

Round 5: the pool runs SHAPE-BUCKETED (pipeline.prepare.plan_buckets,
default 3 buckets) — pairs grouped by their own kernel dims instead of
one pool-max bucket; identical per-pair trajectories, ~1.5x less kernel
volume (see PERF.md).  Each bucket streams with its own checkpoint;
completed buckets park their results in <ckpt>.bK.done.npz so a kill
in bucket K resumes WITHOUT re-running buckets < K.

Quality gates: every pair must converge; the real
golden pair keeps BOTH its error band AND its golden compatibility
count (133 +- 2) INSIDE the sweep — the same bar the bench enforces.

Usage:
    python tools/sweep383.py [--n 383] [--width 2] [--out sweep383.jsonl]
        [--buckets 3]             # shape buckets (1 = round-4 protocol)
        [--trimmed]               # 383-pair trimmed (dissimilar-style)
        [--kill-after-chunks N]   # exits after N chunks (state saved);
                                  # re-run WITHOUT the flag to resume
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=383)
    ap.add_argument("--width", type=int, default=2)
    ap.add_argument("--chunk-steps", type=int, default=512)
    ap.add_argument("--buckets", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--trimmed", action="store_true",
                    help="383-pair trimmed dissimilar-style pool "
                         "(trimFraction=0.1) instead of the similar pool")
    ap.add_argument("--kill-after-chunks", type=int, default=None)
    ap.add_argument("--verbose", action="store_true",
                    help="per-chunk progress prints (each costs a window "
                         "state device_get)")
    ap.add_argument("--ckpt-every", type=int, default=8)
    args = ap.parse_args()

    from goicp_tpu.bench.measure import (TRIM_FRACTION, bench_shape,
                                         build_batch_buckets,
                                         build_trimmed_batch_buckets)
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.search.device_engine import DeviceResult
    from goicp_tpu.search.fused_stream import register_fused_stream

    tag = "trimmed" if args.trimmed else "similar"
    if args.out is None:
        args.out = os.path.join(
            REPO, "sweep383_trimmed.jsonl" if args.trimmed
            else "sweep383.jsonl")
    if args.ckpt is None:
        args.ckpt = os.path.join(REPO, f".sweep383_{tag}.npz")

    cfg = GoICPConfig.from_file("/root/reference/config.txt")
    cfg = bench_shape(cfg)
    if args.trimmed:
        cfg = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                  trans_capacity=256)

    t0 = time.time()
    if args.trimmed:
        buckets = build_trimmed_batch_buckets(cfg, args.n,
                                              max_buckets=args.buckets)
        names = [f"trm{i:02d}" for i in range(args.n)]
    else:
        buckets = build_batch_buckets(cfg, args.n, max_buckets=args.buckets)
        names = ["similar1_2x86_3->1eq2_6", "similar2_2ktd_1->4imo_2"] + \
            [f"syn{i:02d}" for i in range(args.n - 2)]
    prep_s = time.time() - t0
    print(f"prepared {len(buckets)} bucket(s) over {args.n} {tag} pairs "
          f"in {prep_s:.1f}s", flush=True)

    def progress(p):
        inflight = [r for r in p["rows"] if not r["dead"]]
        best = min((r["incumbent"] for r in inflight), default=float("nan"))
        print(f"chunk {p['chunk']:4d}: in-flight="
              f"{[r['pair'] for r in inflight]} "
              f"outer={[r['outer'] for r in inflight]} "
              f"best_incumbent={best:.3f}", flush=True)

    rows: dict[int, dict] = {}
    t0 = time.time()
    for bi, (bp, idxs) in enumerate(buckets):
        done_path = f"{args.ckpt}.b{bi}.done.npz"
        if os.path.exists(done_path):
            with np.load(done_path) as z:
                out = DeviceResult(*(z[f] for f in DeviceResult._fields))
            print(f"bucket {bi}: {len(idxs)} pairs already done (resume)",
                  flush=True)
        else:
            try:
                out = register_fused_stream(
                    bp, cfg, width=args.width, chunk_steps=args.chunk_steps,
                    checkpoint_path=f"{args.ckpt}.b{bi}", resume=True,
                    max_chunks=args.kill_after_chunks,
                    progress=progress if args.verbose else None,
                    checkpoint_every=args.ckpt_every)
            except RuntimeError as e:
                print(f"KILLED (as requested, bucket {bi}): {e}",
                      flush=True)
                return 3
            np.savez(done_path, **{f: np.asarray(getattr(out, f))
                                   for f in DeviceResult._fields})
            if os.path.exists(f"{args.ckpt}.b{bi}"):
                os.unlink(f"{args.ckpt}.b{bi}")
        for j, i in enumerate(idxs):
            rows[i] = {f: np.asarray(getattr(out, f))[j]
                       for f in DeviceResult._fields}
    reg_s = time.time() - t0

    with open(args.out, "w") as fh:
        for i in range(args.n):
            r = rows[i]
            fh.write(json.dumps({
                "pair": names[i],
                "error": round(float(r["error"]), 6),
                "geom": round(float(r["terms"][0]), 6),
                "incomp": round(float(r["terms"][1]), 6),
                "fpfh": round(float(r["terms"][2]), 6),
                "compat": int(r["opt_comp"]),
                "gap": round(float(r["gap"]), 6),
                "converged": bool(r["converged"]),
                "outer": int(r["outer_iters"]),
                "inner": int(r["inner_iters"]),
                "evals": int(r["evals"]),
                "icp_runs": int(r["icp_runs"]),
            }) + "\n")

    conv = np.array([bool(rows[i]["converged"]) for i in range(args.n)])
    evals = int(sum(int(rows[i]["evals"]) for i in range(args.n)))
    print(f"SWEEP DONE ({tag}): {args.n} pairs, registration wall "
          f"{reg_s:.1f}s = {args.n / reg_s:.3f} pairs/s, prep "
          f"{prep_s:.1f}s, {int(conv.sum())}/{args.n} converged, "
          f"{evals} bound evals ({evals / reg_s:.0f}/s); "
          f"rows -> {args.out}", flush=True)
    assert conv.all(), f"unconverged pairs: {np.where(~conv)[0].tolist()}"
    if not args.trimmed:
        # golden parity INSIDE the sweep — the same bar as the bench
        # (bench/measure._check_parity): error band AND compat count
        eps1 = cfg.MSEThresh * 238
        err1 = float(rows[0]["error"])
        assert abs(err1 - 8.45388) < eps1, err1
        comp1 = 238 - int(rows[0]["opt_comp"])
        assert abs(comp1 - 133) <= 2, \
            (f"pair-1 compat {comp1} != golden 133+-2 — basin swap "
             f"inside the sweep (error {err1:.4f})")
    for bi in range(len(buckets)):
        for p in (f"{args.ckpt}.b{bi}", f"{args.ckpt}.b{bi}.done.npz"):
            if os.path.exists(p):
                os.unlink(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
