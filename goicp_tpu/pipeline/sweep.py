"""BO1 dataset sweep (the equivalent of bo1_GoICP.py).

Reference behavior (bo1_GoICP.py:40-68): for every pair (source, target)
from the similar/dissimilar TSVs, run
    ./GoICP cavities/<target>.mol2 cavities/<source>.mol2 <N> config.txt
            output/<kind><k>.txt <k>
where <N> is the source cavity's atom count (i.e. no actual downsampling).

This driver adds what the reference lacks (SURVEY.md section 5): per-pair
structured JSONL results, idempotent resume (skip pairs whose output exists),
and the RMSD evaluation wired in-line instead of being commented out.
"""

from __future__ import annotations

import json
import os
import time

from goicp_tpu.config import GoICPConfig
from goicp_tpu.io.mol2 import mol2_atom_count
from goicp_tpu.io.tsv import read_pair_list
from goicp_tpu.pipeline.pair import run_pair


def run_sweep(data_root: str, cfg: GoICPConfig, out_dir: str,
              kind: str = "similar", limit: int | None = None,
              start: int = 0, resume: bool = True, verbose: bool = False,
              with_rmsd: bool = True, retries: int = 1,
              engine: str = "host"):
    """data_root: directory holding cavities/, cfpfh/, chains/, ref_proteins/
    and the BO1 tsv files (i.e. a checkout of the reference data).

    engine: "host", "device" (one XLA program per pair), "device-batch"
    (distinct pairs registered together, one vmapped program per chunk),
    or "fused" (cross-pair fused stream — the fastest path; every
    in-flight pair advances per while_loop iteration)."""
    if engine in ("device-batch", "fused"):
        from goicp_tpu.pipeline.device_sweep import run_sweep_device_batch
        return run_sweep_device_batch(
            data_root, cfg, out_dir, kind=kind, limit=limit, start=start,
            resume=resume, with_rmsd=with_rmsd, verbose=verbose,
            runner="fused" if engine == "fused" else "compact")
    tsv = os.path.join(data_root, f"cavities_{kind}_BO1_clean.tsv")
    pairs = read_pair_list(tsv)
    if limit is not None:
        pairs = pairs[start:start + limit]
    else:
        pairs = pairs[start:]

    os.makedirs(out_dir, exist_ok=True)
    results_path = os.path.join(out_dir, f"results_{kind}.jsonl")
    results = []
    for off, (src, tgt) in enumerate(pairs):
        k = start + off + 1
        out_file = os.path.join(out_dir, "output", f"{kind}{k}.txt")
        if resume and os.path.exists(out_file):
            continue
        data_file = os.path.join(data_root, "cavities", f"{src}_cavity6.mol2")
        model_file = os.path.join(data_root, "cavities", f"{tgt}_cavity6.mol2")
        missing = [p for p in (data_file, model_file) if not os.path.exists(p)]
        if missing:
            # the reference checks in only a handful of the BO1 cavity files;
            # skip absent pairs instead of dying mid-sweep (the reference's
            # bo1_GoICP.py would crash here)
            with open(results_path, "a") as fh:
                fh.write(json.dumps(dict(
                    pair=k, kind=kind, source=src, target=tgt,
                    skipped=True, missing=[os.path.basename(m)
                                           for m in missing])) + "\n")
            continue
        n = mol2_atom_count(data_file)
        t0 = time.time()
        res = None
        for attempt in range(retries + 1):
            try:
                res = run_pair(
                    model_file, data_file, cfg, nd_downsampled=n,
                    output_file=out_file, pair_id=k, out_dir=out_dir,
                    cfpfh_dir=os.path.join(data_root, "cfpfh"),
                    chains_dir=os.path.join(data_root, "chains")
                    if with_rmsd else None,
                    ref_proteins_dir=os.path.join(data_root, "ref_proteins")
                    if with_rmsd else None,
                    verbose=verbose, engine=engine)
                break
            except Exception as exc:   # per-pair failure isolation
                if attempt == retries:
                    with open(results_path, "a") as fh:
                        fh.write(json.dumps(dict(
                            pair=k, kind=kind, source=src, target=tgt,
                            failed=True, error_msg=str(exc)[:500])) + "\n")
                    res = None
        if res is None:
            continue
        reg = res.registration
        row = dict(pair=k, kind=kind, source=src, target=tgt,
                   error=reg.error, geom_error=reg.geom_error,
                   incomp_error=reg.incomp_error, fpfh_error=reg.fpfh_error,
                   compatibilities=reg.compatibilities, rmsd=res.rmsd,
                   time_s=time.time() - t0, outer_steps=reg.outer_steps,
                   bound_evals=reg.bound_evals, icp_runs=reg.icp_runs,
                   converged=reg.converged, gap=reg.gap)
        results.append(row)
        with open(results_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        if verbose:
            print(f"[{k}] {src} -> {tgt}: err {reg.error:.4f} "
                  f"comp {reg.compatibilities} rmsd {res.rmsd} "
                  f"({row['time_s']:.2f}s)")
    return results
