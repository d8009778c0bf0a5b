"""BO1 sweep on the batched device engine: many DISTINCT pairs per dispatch.

The per-pair sweep (pipeline/sweep.py) registers one pair at a time; even
the fully device-side engine then leaves most of the chip idle between tiny
programs.  Here the sweep's runnable pairs are padded into one shared shape
bucket, their REAL point counts moved into a device leaf
(prepare.make_count_dynamic), and registered in chunks of `batch_size` as
ONE vmapped XLA program each — the single-device form of pair-level
data parallelism (SURVEY.md §2.4 item 1).  Trimmed configs (the
outlier-robust dissimilar-batch setting) work too: per-pair inlier counts
ride in the dynamic-counts device leaf.

Outputs are byte-compatible with the per-pair sweep: output/<kind><k>.txt,
*_rescaled.txt, cavitiesN clouds, rot proteins + resultsRMSD.txt, and one
JSONL row per pair.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.io.mol2 import mol2_atom_count
from goicp_tpu.io.tsv import read_pair_list
from goicp_tpu.pipeline.pair import (adapt_device_result, finish_pair_run,
                                     load_pair_inputs)
from goicp_tpu.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                        prepare_pair)


def run_sweep_device_batch(data_root: str, cfg: GoICPConfig, out_dir: str,
                           kind: str = "similar",
                           limit: int | None = None, start: int = 0,
                           resume: bool = True, with_rmsd: bool = True,
                           batch_size: int = 64, verbose: bool = False,
                           mesh=None, runner: str = "compact"):
    """data_root: reference-data checkout (cavities/, cfpfh/, chains/,
    ref_proteins/, BO1 tsv files).  mesh: optional Mesh with a `data` axis
    for multi-chip pair DP.  runner: "compact" (convergence-compacted
    vmapped chunks, search/chunked.py) or "fused" (cross-pair fused
    stream, search/fused_stream.py — the round-3 bench engine)."""
    tsv = os.path.join(data_root, f"cavities_{kind}_BO1_clean.tsv")
    pairs = read_pair_list(tsv)
    pairs = pairs[start:start + limit] if limit is not None else pairs[start:]

    os.makedirs(out_dir, exist_ok=True)
    results_path = os.path.join(out_dir, f"results_{kind}.jsonl")

    # ---- phase 1 (host): load + normalize every runnable pair ----
    runnable = []      # (k, src, tgt, inputs, n_downsampled, out_file)
    for off, (src, tgt) in enumerate(pairs):
        k = start + off + 1
        out_file = os.path.join(out_dir, "output", f"{kind}{k}.txt")
        if resume and os.path.exists(out_file):
            continue
        data_file = os.path.join(data_root, "cavities", f"{src}_cavity6.mol2")
        model_file = os.path.join(data_root, "cavities",
                                  f"{tgt}_cavity6.mol2")
        missing = [p for p in (data_file, model_file)
                   if not os.path.exists(p)]
        if missing:
            with open(results_path, "a") as fh:
                fh.write(json.dumps(dict(
                    pair=k, kind=kind, source=src, target=tgt, skipped=True,
                    missing=[os.path.basename(m) for m in missing])) + "\n")
            continue
        inputs = load_pair_inputs(model_file, data_file, cfg, pair_id=k,
                                  out_dir=out_dir,
                                  cfpfh_dir=os.path.join(data_root, "cfpfh")
                                  if cfg.cfpfh != 0 else None)
        runnable.append((k, src, tgt, inputs, mol2_atom_count(data_file),
                         out_file))
    if not runnable:
        return []

    # ---- phase 2 (host): SHAPE BUCKETS over the sweep: pairs grouped by
    # their own dims (plan_buckets) instead of one pool-max bucket, so a
    # small pair does not pay the largest pair's padding; trajectories
    # are padding-invariant so results are identical
    # (tests/test_bucketing.py) ----
    from goicp_tpu.pipeline.prepare import plan_buckets
    dims_list = []
    for _, _, _, inputs, n_ds, _ in runnable:
        nd = min(n_ds, len(inputs.src_n)) if n_ds > 0 else len(inputs.src_n)
        dims_list.append(bucket_dims(inputs.tgt_n, nd,
                                     len(inputs.tgt_n), cfg))
    plan = plan_buckets(dims_list, max_buckets=3)

    prepared_all: list = [None] * len(runnable)
    for bd, idxs in plan:
        for i in idxs:
            k, src, tgt, inputs, n_ds, out_file = runnable[i]
            pair = prepare_pair(inputs.src_n, inputs.tgt_n, inputs.src_props,
                                inputs.tgt_props, cfg, inputs.src_fpfh,
                                inputs.tgt_fpfh, nd_downsampled=n_ds, **bd)
            prepared_all[i] = make_count_dynamic(pair)
    # bucket-contiguous execution order (each bucket shares one compiled
    # program; pair ids ride in the JSONL rows, so order is free)
    exec_order = [i for _, idxs in plan for i in idxs]
    bucket_of = {i: bi for bi, (_, idxs) in enumerate(plan) for i in idxs}

    # ---- phase 3 (device): per-bucket chunks of batch_size,
    # convergence-compacted chunked execution (hard pairs finish at small
    # batch widths instead of dragging the whole batch; tail chunks pad
    # with pre-converged rows so the same-bucket compilation is reused
    # without duplicate work) ----
    from goicp_tpu.search.chunked import register_device_batch_compact
    from goicp_tpu.search.fused_stream import register_fused_stream
    results = []
    chunks = []
    bucket_first = []        # per chunk: first chunk of its bucket?
    for bi in range(len(plan)):
        b_idxs = [i for i in exec_order if bucket_of[i] == bi]
        for lo in range(0, len(b_idxs), batch_size):
            chunks.append(b_idxs[lo:lo + batch_size])
            bucket_first.append(lo == 0)
    for chunk_no, chunk_idxs in enumerate(chunks):
        chunk = [prepared_all[i] for i in chunk_idxs]
        rows = [runnable[i] for i in chunk_idxs]
        n_real = len(chunk)
        t0 = time.time()
        if runner == "fused":
            # width must be a multiple of the mesh data-axis size (the
            # fused stream shards the window's pair axis over it); 2 is
            # the bench's FUSED_WIDTH
            fw = 2 if mesh is None else max(2, mesh.shape["data"])
            if mesh is not None:
                d = mesh.shape["data"]
                fw = -(-fw // d) * d
            out = register_fused_stream(chunk, cfg, width=fw,
                                        chunk_steps=512, mesh=mesh)
        else:
            # ragged tail chunks pad with pre-converged rows so the
            # bucket's full batch_size compilation is reused (a bucket's
            # FIRST chunk compiles at its own width instead)
            out = register_device_batch_compact(
                chunk, cfg, mesh=mesh,
                pad_to=batch_size if n_real < batch_size
                and not bucket_first[chunk_no] else None)
        wall = time.time() - t0
        per_pair_s = wall / n_real

        for i, (k, src, tgt, inputs, _, out_file) in enumerate(rows):
            row_res = type(out)(*(np.asarray(leaf)[i] for leaf in out))
            n_data = int(np.sum(np.asarray(chunk[i].data_mask) > 0))
            reg = adapt_device_result(row_res, n_data, per_pair_s)
            res = finish_pair_run(
                inputs, reg, output_file=out_file, out_dir=out_dir,
                chains_dir=os.path.join(data_root, "chains")
                if with_rmsd else None,
                ref_proteins_dir=os.path.join(data_root, "ref_proteins")
                if with_rmsd else None)
            row = dict(pair=k, kind=kind, source=src, target=tgt,
                       error=reg.error, geom_error=reg.geom_error,
                       incomp_error=reg.incomp_error,
                       fpfh_error=reg.fpfh_error,
                       compatibilities=reg.compatibilities, rmsd=res.rmsd,
                       time_s=per_pair_s, outer_steps=reg.outer_steps,
                       bound_evals=reg.bound_evals, converged=reg.converged,
                       gap=reg.gap,
                       engine="fused" if runner == "fused"
                       else "device-batch",
                       batch=n_real, batch_wall_s=wall)
            results.append(row)
            with open(results_path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
            if verbose:
                print(f"[{k}] {src} -> {tgt}: err {reg.error:.4f} "
                      f"comp {reg.compatibilities} rmsd {res.rmsd} "
                      f"({per_pair_s:.3f}s/pair in batch {n_real})")
    return results
