"""Wide-shape study on the hard pair (BO1 pair 2, 2ktd_1 -> 4imo_2).

Measures how popping MORE nodes per sequential step (rot_batch x trans_pop
x trans_capacity) trades per-iteration kernel volume against sequential
depth — the input to the fused stream's straggler shape escalation.  The reference pops ONE node per step from one global
queue (jly_goicp.cpp:668-712); a width-W pop divides the sequential chain
by up to W where lb-ordering quality permits.

Run (one JAX process per GPU):
  python tools/wide_study.py [shape_index ...]
"""

import dataclasses
import json
import sys
import time

REF = "/root/reference"

SHAPES = [
    # (rot_batch, trans_pop, trans_capacity)  [device_rot_capacity kept 2048]
    (1, 8, 128),      # round-3 bench shape (baseline)
    (2, 8, 128),
    (4, 8, 128),
    (1, 16, 256),
    (2, 16, 256),
    (4, 16, 256),
    (8, 16, 256),
    (4, 32, 256),
    (8, 32, 512),
]


def main():
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.geom.normalize import normalize_pair
    from goicp_tpu.io.mol2 import read_mol_file
    from goicp_tpu.io.xyz import quantize_like_file
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search.device_engine import register_device
    import jax

    base = GoICPConfig.from_file(f"{REF}/config.txt")
    src, sp = read_mol_file(f"{REF}/cavities/2ktd_1_cavity6.mol2")
    tgt, tp = read_mol_file(f"{REF}/cavities/4imo_2_cavity6.mol2")
    norm = normalize_pair(src, tgt)
    nd = len(src)

    idxs = [int(a) for a in sys.argv[1:]] or list(range(len(SHAPES)))
    for i in idxs:
        rb, tp_, tc = SHAPES[i]
        cfg = dataclasses.replace(base, rot_batch=rb, trans_pop=tp_,
                                  trans_capacity=tc, icp_seeds=4,
                                  margin_frac=0.9)
        pair = prepare_pair(quantize_like_file(norm["source"]),
                            quantize_like_file(norm["target"]),
                            sp, tp, cfg, nd_downsampled=nd, bucket=True)
        res = jax.device_get(register_device(pair, cfg))        # warm
        t0 = time.time()
        res = jax.device_get(register_device(pair, cfg))
        wall = time.time() - t0
        print(json.dumps({
            "shape": [rb, tp_, tc], "wall_s": round(wall, 3),
            "outer": int(res.outer_iters), "inner": int(res.inner_iters),
            "evals": int(res.evals), "error": round(float(res.error), 4),
            "gap": round(float(res.gap), 4),
            "converged": bool(res.converged),
            "us_per_inner_it": round(1e6 * wall / max(int(res.inner_iters)
                                                      + int(res.outer_iters),
                                                      1), 1),
        }), flush=True)


if __name__ == "__main__":
    main()
