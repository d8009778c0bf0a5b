"""Sweep search-shape knobs for the batched device engine on the real chip.

Prints one JSON line per (config, batch) trial.  Run as a single process
(one JAX process per GPU):
  python tools/tune_batch.py
"""

import dataclasses
import json
import time

REF = "/root/reference"


def main():
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.geom.normalize import normalize_pair
    from goicp_tpu.io.mol2 import read_mol_file
    from goicp_tpu.io.xyz import quantize_like_file
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search.device_engine import (register_device,
                                                register_device_batch)
    import jax
    import numpy as np

    base = GoICPConfig.from_file(f"{REF}/config.txt")
    src, sp = read_mol_file(f"{REF}/cavities/2x86_3_cavity6.mol2")
    tgt, tp = read_mol_file(f"{REF}/cavities/1eq2_6_cavity6.mol2")
    norm = normalize_pair(src, tgt)
    eps = base.MSEThresh * 238

    variants = [dict(rot_batch=1, trans_capacity=64, icp_seeds=4),
                dict(rot_batch=2, trans_capacity=64, icp_seeds=4),
                dict(rot_batch=1, trans_capacity=64, icp_seeds=8),
                dict(rot_batch=2, trans_capacity=64, icp_seeds=8)]

    batches = (1, 64, 128, 256)
    for var in variants:
        cfg = dataclasses.replace(base, **var)
        pair = prepare_pair(quantize_like_file(norm["source"]),
                            quantize_like_file(norm["target"]),
                            sp, tp, cfg, nd_downsampled=238, bucket=True)
        for batch in batches:
            try:
                if batch == 1:
                    jax.device_get(register_device(pair, cfg))   # warm
                    t0 = time.time()
                    res = jax.device_get(register_device(pair, cfg))
                    wall = time.time() - t0
                    ok = bool(res.converged) and \
                        abs(float(res.error) - 8.45388) < eps and \
                        abs((238 - int(res.opt_comp)) - 133) <= 2
                else:
                    pairs = [pair] * batch
                    register_device_batch(pairs, cfg)            # warm
                    t0 = time.time()
                    out = register_device_batch(pairs, cfg)
                    wall = time.time() - t0
                    comp = 238 - np.asarray(out.opt_comp)
                    ok = bool(np.all(np.abs(np.asarray(out.error) - 8.45388)
                                     < eps)
                              and np.all(np.abs(comp - 133) <= 2))
                print(json.dumps({**var, "batch": batch,
                                  "wall_s": round(wall, 4),
                                  "pairs_per_s": round(batch / wall, 2),
                                  "ok": ok}), flush=True)
            except Exception as e:  # keep sweeping on a bad variant
                print(json.dumps({**var, "batch": batch,
                                  "error": repr(e)[:200]}), flush=True)


if __name__ == "__main__":
    main()
