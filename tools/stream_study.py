"""Measure the 64-pair bench workload on the chip at several stream widths
and dump per-pair difficulty (outer/inner iterations, bound evals, wall).

Answers: is the stream's wall dominated by window COUPLING (vmapped chunks
cost the max over rows -> wide windows waste latency-bound iterations) or
by pairs that are intrinsically slow for this engine?  Prints a JSON line
per width plus the top-10 hardest pairs, cross-referenced against the
reference binary's per-pair walls (REF_BASELINE_WORKLOAD.json).

Usage: python tools/stream_study.py [width:trans_pop ...]
       (default combos: 8:32 8:16 4:32 8:8)
"""

from __future__ import annotations

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
    # args: "width:trans_pop" combos, most promising first (partial output
    # is still useful when a run is cut); single timed run per combo
    def _combo(a: str):
        parts = [int(x) for x in a.split(":")]
        return (parts[0], parts[1] if len(parts) > 1 else 8)

    combos = [_combo(a) for a in sys.argv[1:]] \
        or [(8, 32), (8, 16), (4, 32), (8, 8)]

    from goicp_tpu.bench.measure import BATCH, build_batch, _check_parity
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.search.chunked import register_device_stream
    import jax

    base = GoICPConfig.from_file(f"{REF}/config.txt")

    ref = None
    ref_names = [str(i) for i in range(BATCH)]
    try:
        with open(os.path.join(REPO, "REF_BASELINE_WORKLOAD.json")) as fh:
            ref = {r["pair"]: r["wall_s"]
                   for r in json.load(fh)["pairs"]}
            ref_names = list(ref.keys())
    except Exception:
        pass

    print("platform:", jax.devices()[0].platform, flush=True)
    pairs = None
    for width, pop in combos:
        cfg = dataclasses.replace(base, rot_batch=1, trans_capacity=64,
                                  trans_pop=pop, icp_seeds=4,
                                  max_outer_steps=4000)
        if pairs is None:
            pairs = build_batch(cfg, BATCH)
        t0 = time.time()
        out = register_device_stream(pairs, cfg, width=width, chunk_steps=32)
        cold = time.time() - t0                 # includes compile
        _check_parity(out, cfg, pairs)
        print(f"  [{width}:{pop}] cold(incl compile) {cold:.1f}s",
              flush=True)
        t0 = time.time()
        out = register_device_stream(pairs, cfg, width=width, chunk_steps=32)
        wall = time.time() - t0
        _check_parity(out, cfg, pairs)
        evals = int(np.sum(np.asarray(out.evals)))
        print(json.dumps({
            "width": width, "trans_pop": pop, "wall_s": round(wall, 2),
            "pairs_per_s": round(BATCH / wall, 4),
            "bound_evals_per_s": round(evals / wall),
            "total_inner_iters": int(np.sum(np.asarray(out.inner_iters))),
            "total_outer": int(np.sum(np.asarray(out.outer_iters))),
        }), flush=True)
        inner = np.asarray(out.inner_iters)
        order = np.argsort(-inner)
        print("  hardest pairs (by inner iters):", flush=True)
        for i in order[:6]:
            name = ref_names[i] if i < len(ref_names) else str(i)
            rw = ref.get(name, float("nan")) if ref else float("nan")
            print(f"    {name:24s} outer={int(out.outer_iters[i]):6d} "
                  f"inner={int(inner[i]):8d} "
                  f"evals={int(out.evals[i]):9d} "
                  f"err={float(out.error[i]):8.3f} "
                  f"ref_wall={rw:7.2f}s", flush=True)


if __name__ == "__main__":
    main()
