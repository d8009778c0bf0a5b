"""A/B single-pair device-engine walls on BO1 pair 2 (the eval-heavy
straggler: ~3.4M bound evals — thousands of pure inner iterations, the
most sensitive on-chip probe of per-iteration cost changes).

Usage (GPU):  python tools/ab_single.py key=val [key=val ...] -- key2=val2 ...
Each `--`-separated group is one config variant overlaid on the bench
shape; each variant runs 1 warm + 3 measured walls.
"""

import dataclasses
import json
import sys
import time

REF = "/root/reference"


def main():
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.geom.normalize import normalize_pair
    from goicp_tpu.io.mol2 import read_mol_file
    from goicp_tpu.io.xyz import quantize_like_file
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search.device_engine import register_device
    import jax
    import numpy as np

    groups = [[]]
    for a in sys.argv[1:]:
        if a == "--":
            groups.append([])
        else:
            groups[-1].append(a)

    from goicp_tpu.bench.measure import bench_shape
    base = bench_shape(GoICPConfig.from_file(f"{REF}/config.txt"))
    src, sp = read_mol_file(f"{REF}/cavities/2ktd_1_cavity6.mol2")
    tgt, tp = read_mol_file(f"{REF}/cavities/4imo_2_cavity6.mol2")
    norm = normalize_pair(src, tgt)

    for g in groups:
        kw = {}
        for item in g:
            k, v = item.split("=", 1)
            kw[k] = type(getattr(base, k))(
                float(v) if "." in v else int(v)) \
                if not isinstance(getattr(base, k), float) else float(v)
        cfg = dataclasses.replace(base, **kw)
        pair = prepare_pair(quantize_like_file(norm["source"]),
                            quantize_like_file(norm["target"]),
                            sp, tp, cfg, bucket=True)
        r = jax.device_get(register_device(pair, cfg))      # warm/compile
        walls = []
        for _ in range(3):
            t0 = time.time()
            r = jax.device_get(register_device(pair, cfg))
            walls.append(time.time() - t0)
        print(json.dumps({
            "cfg": kw, "walls": [round(w, 3) for w in walls],
            "best": round(min(walls), 3),
            "err": round(float(r.error), 4),
            "conv": bool(r.converged), "evals": int(r.evals),
            "inner_iters": int(r.inner_iters),
            "chem_corners": int(r.chem_corners)}), flush=True)


if __name__ == "__main__":
    main()
