"""Measure the cross-pair fused stream engine on the 64-pair bench
workload at several window widths (GPU).  Usage:
    python tools/fused_study.py [width:chunk ...] [cfgkey=val ...]
(default widths 8:512 16:512 4:512; cfg overrides apply to every combo
on top of bench_shape — e.g. `icp_seeds=1` for the ICP-cost ablation)
"""
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from goicp_tpu.bench.measure import build_batch, _check_parity
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.search.fused_stream import register_fused_stream

    def combo(a):
        p = [int(x) for x in a.split(":")]
        return (p[0], p[1] if len(p) > 1 else 512)

    combos = [combo(a) for a in sys.argv[1:] if "=" not in a] \
        or [(8, 512), (16, 512), (4, 512)]
    overrides = {}
    for a in sys.argv[1:]:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = float(v) if "." in v else int(v)
    from goicp_tpu.bench.measure import bench_shape
    cfg0 = GoICPConfig.from_file("/root/reference/config.txt")
    cfg = dataclasses.replace(bench_shape(cfg0), **overrides)
    print(f"overrides={overrides}", flush=True)
    pairs = build_batch(cfg, 64)
    for width, chunk in combos:
        t0 = time.time()
        out = register_fused_stream(pairs, cfg, width=width,
                                    chunk_steps=chunk)
        w_warm = time.time() - t0
        _check_parity(out, cfg, pairs)
        t0 = time.time()
        out = register_fused_stream(pairs, cfg, width=width,
                                    chunk_steps=chunk)
        w = time.time() - t0
        _check_parity(out, cfg, pairs)
        ev = int(np.sum(np.asarray(out.evals)))
        print(f"width={width} chunk={chunk}: warm={w_warm:.1f}s "
              f"steady={w:.1f}s pairs/s={64 / w:.3f} evals/s={ev / w:.0f}",
              flush=True)


if __name__ == "__main__":
    main()
