"""A/B: the 64-pair bench workload through ONE shape bucket (pool-max
dims, the round-4 protocol) vs SHAPE-BUCKETED fused streams (pairs
grouped by their own kernel dims, one stream per bucket).

The hot kernels' work tile is (pad_cells x ceil(pad_data, 128)); one
pool-wide bucket pads every pair to the pool max (measured 1.8x mean
wasted volume, 2.7x on the eval-heavy pair 2).  Trajectories are
padding-invariant, so per-pair results/evals must be IDENTICAL — this
study checks that and measures the wall.

Usage (GPU): python tools/bucket_study.py [--buckets 3] [--trimmed]
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
REF = "/root/reference"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--buckets", type=int, default=3)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--trimmed", action="store_true")
    ap.add_argument("--skip-single", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg overrides key=val (applied after bench_shape)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunk_steps override (default FUSED_CHUNK)")
    ap.add_argument("--escalate", type=int, default=None,
                    help="escalate_capacity for eval-heavy rows")
    ap.add_argument("--escalate-after", type=int, default=8,
                    help="chunks a row must survive before escalation")
    args = ap.parse_args()

    from goicp_tpu.bench.measure import (FUSED_CHUNK, FUSED_WIDTH,
                                         TRIM_FRACTION, _check_parity,
                                         _load_real_pair,
                                         normalized_synthetic, bench_shape,
                                         synthetic_pool,
                                         synthetic_pool_trimmed)
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                            plan_buckets, prepare_pair)
    from goicp_tpu.search.fused_stream import register_fused_stream
    import jax

    cfg = bench_shape(GoICPConfig.from_file(f"{REF}/config.txt"))
    for item in args.set:
        k, v = item.split("=", 1)
        cur = getattr(cfg, k)
        cfg = dataclasses.replace(
            cfg, **{k: float(v) if isinstance(cur, float) else int(v)})
    if args.trimmed:
        cfg = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                  trans_capacity=256)
        raw = [normalized_synthetic(e)
               for e in synthetic_pool_trimmed(args.n)]
    else:
        raw = [_load_real_pair("2x86_3", "1eq2_6", cfg),
               _load_real_pair("2ktd_1", "4imo_2", cfg)]
        raw += [normalized_synthetic(e)
                for e in synthetic_pool(args.n - 2)]

    dims_list = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raw]
    print("platform:", jax.devices()[0].platform, flush=True)

    def prep(bd, idxs):
        return [make_count_dynamic(prepare_pair(*raw[i], cfg, **bd))
                for i in idxs]

    chunk_steps = args.chunk or FUSED_CHUNK

    def run(pairs):
        return register_fused_stream(
            pairs, cfg, width=FUSED_WIDTH, chunk_steps=chunk_steps,
            escalate_capacity=args.escalate,
            escalate_after_chunks=args.escalate_after)

    # ---- baseline: one pool-max bucket ----
    if not args.skip_single:
        pool_bd = {k: max(d[k] for d in dims_list) for k in dims_list[0]}
        pairs1 = prep(pool_bd, list(range(len(raw))))
        out1 = run(pairs1)                        # warm
        walls1 = []
        for _ in range(2):
            t0 = time.time()
            out1 = run(pairs1)
            walls1.append(time.time() - t0)
        if not args.trimmed:
            _check_parity(out1, cfg, pairs1)
        ev1 = {i: int(out1.evals[i]) for i in range(len(raw))}
        print(json.dumps({"mode": "single", "dims": pool_bd,
                          "walls": [round(w, 2) for w in walls1],
                          "pairs_per_s": round(len(raw) / min(walls1), 3)}),
              flush=True)
    else:
        ev1 = None

    # ---- bucketed ----
    plan = plan_buckets(dims_list, max_buckets=args.buckets)
    buckets = [(bd, idxs, prep(bd, idxs)) for bd, idxs in plan]
    for bd, idxs, pairs in buckets:               # warm all programs
        run(pairs)
    walls = []
    for _ in range(2):
        t0 = time.time()
        outs = [(idxs, run(pairs)) for _, idxs, pairs in buckets]
        walls.append(time.time() - t0)
    conv_all, evals = True, {}
    for idxs, out in outs:
        conv_all &= bool(np.asarray(out.converged).all())
        for j, i in enumerate(idxs):
            evals[i] = int(out.evals[j])
    assert conv_all
    if ev1 is not None:
        same = all(ev1[i] == evals[i] for i in range(len(raw)))
        print("per-pair evals identical to single-bucket:", same,
              flush=True)
    print(json.dumps({
        "mode": f"bucketed-{len(buckets)}",
        "buckets": [{"dims": bd, "n": len(idxs)}
                    for bd, idxs, _ in buckets],
        "walls": [round(w, 2) for w in walls],
        "pairs_per_s": round(len(raw) / min(walls), 3)}), flush=True)


if __name__ == "__main__":
    main()
