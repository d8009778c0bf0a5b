"""Benchmark measurement (called in-process by bench.py).

Measures DISTINCT-pair registration throughput on TWO workloads:

  * similar: the two real BO1 golden pairs + synthetic rigid-subset
    pairs spanning the BO1 cavity size range (165-306 points);
  * trimmed dissimilar-style: noisy/outlier synthetic pairs registered
    with trimFraction (BASELINE.json config 4).

Both run through the cross-pair fused stream (search/fused_stream.py) at
the shared search shape (bench_shape), with golden parity and the
convergence-margin guard asserted in-run.  Identical pairs would converge
in lockstep and flatter the measurement; distinct pairs with distinct
convergence behavior measure what a real sweep sees.

Reports both BASELINE.json metrics:
  * pairs_per_s        — batch / wall (per workload)
  * bound_evals_per_s  — total translation-node bound evaluations / wall
    (each eval = one (node x Nd) DT-lookup + trim + ub/lb computation, the
    reference's InnerBnB per-node hot loop, jly_goicp.cpp:343-415)

The golden pairs are read from the reference checkout at REF; making the
inputs self-contained is ROADMAP A1.
"""

import json
import time

import numpy as np

REF = "/root/reference"
BATCH = 64
TRIM_BATCH = 32     # trimmed (dissimilar-style) workload size
TRIM_FRACTION = 0.1  # BASELINE.json config 4 / READMEGo-ICP.md:82-84
FUSED_WIDTH = 2     # fused-stream window (pairs in flight per stream)
FUSED_CHUNK = 512   # global iterations per dispatch
SIMILAR_BUCKETS = 4  # shape buckets of the similar pool
TRIM_BUCKETS = 3     # shape buckets of the trimmed pool
TRIM_CAPACITY = 256  # trimmed pool's translation frontier capacity


def bench_shape(cfg):
    """The shared search shape of the bench, tools/sweep383.py and the A/B
    tools (ONE source of truth).  It was tuned on earlier hardware and is
    not yet re-tuned for the GPU (ROADMAP A3).

    chem_reuse: corner reuse evaluates 19 of the 27 corner-lattice points
    per pop at a bit-identical trajectory.  trans_capacity 128 for the
    similar pool; the eval-heavier trimmed pool runs TRIM_CAPACITY."""
    import dataclasses
    return dataclasses.replace(cfg, rot_batch=1, trans_capacity=128,
                               icp_seeds=4, max_outer_steps=12000,
                               margin_frac=0.9, chem_reuse=1)


def _load_real_pair(src_name: str, tgt_name: str, cfg):
    """Reference-pipeline load: mol2 -> common-scale normalize -> the
    write-then-reload 6-sig-digit quantization (jly_main.cpp:72-99)."""
    from goicp_tpu.geom.normalize import normalize_pair
    from goicp_tpu.io.mol2 import read_mol_file
    from goicp_tpu.io.xyz import quantize_like_file

    src, sp = read_mol_file(f"{REF}/cavities/{src_name}_cavity6.mol2")
    tgt, tp = read_mol_file(f"{REF}/cavities/{tgt_name}_cavity6.mol2")
    norm = normalize_pair(src, tgt)
    return (quantize_like_file(norm["source"]),
            quantize_like_file(norm["target"]), sp, tp)


def _synthetic_pair(rng):
    """A similar-style synthetic RAW pair in the BO1 size envelope: the data
    cloud is a rigidly transformed subset of the model cloud, properties
    carried along.  RAW = pre-normalization coordinates (rounded to 6
    decimals so a %.6f .mol2 round-trip is exact): both our pipeline and
    the reference binary consume these through their own (identical)
    centralize + common-scale + 6-sig-digit quantize paths, so the
    workload-baseline comparison (tools/ref_workload_baseline.py) solves
    the very same normalized problem.

    Returns (data, model, data_prop_idx, model_prop_idx, truth) where
    truth[i] is the model point that data point i was made from."""
    from goicp_tpu.geom.rotation import rodrigues_np

    nm = int(rng.integers(165, 307))
    nd = int(rng.integers(165, nm + 1))
    model = rng.uniform(-0.75, 0.75, size=(nm, 3))
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    tv = rng.uniform(-0.15, 0.15, 3)
    sel = rng.permutation(nm)[:nd]
    data = (model[sel] - tv) @ R
    mp = rng.integers(0, 9, nm).astype(np.int32)
    model = np.round(model, 6)
    return (np.round(data, 6), model, mp[sel].copy(), mp, model[sel])


def synthetic_pool(n: int, seed: int = 7, with_truth: bool = False):
    """The bench's synthetic raw pairs, reproducibly:
    [(name, data_raw f64 (Nd,3), model_raw f64 (Nm,3),
      data_prop_idx i32, model_prop_idx i32)].
    with_truth=True appends each pair's ground truth: the model point
    (raw coordinates) that each data point was made from.
    tools/ref_workload_baseline.py writes THESE clouds to .mol2 and runs
    the reference C++ binary on them — the same-workload comparator."""
    rng = np.random.default_rng(seed)
    pool = [(f"syn{i:02d}",) + _synthetic_pair(rng) for i in range(n)]
    return pool if with_truth else [e[:5] for e in pool]


def _synthetic_pair_noisy(rng):
    """A dissimilar-style synthetic RAW pair: rigid subset PLUS coordinate
    noise and unmatched outlier points (no model counterpart) — the
    workload class the reference handles with trimming
    (cavities_dissimilar_BO1_clean.tsv + trimFraction, READMEGo-ICP.md:82-84,
    trim semantics jly_goicp.cpp:384-390).  Outlier fraction ~10% stays
    below the bench trimFraction so the trimmed optimum still aligns the
    true subset."""
    nm = int(rng.integers(165, 307))
    n_match = int(rng.integers(150, min(nm, 270) + 1))
    n_out = max(1, int(0.10 * n_match / 0.9))      # ~10% of the data cloud
    model = rng.uniform(-0.75, 0.75, size=(nm, 3))
    from goicp_tpu.geom.rotation import rodrigues_np
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    tv = rng.uniform(-0.15, 0.15, 3)
    sel = rng.permutation(nm)[:n_match]
    matched = (model[sel] - tv) @ R
    matched = matched + rng.normal(0.0, 0.004, size=matched.shape)
    outliers = rng.uniform(-0.9, 0.9, size=(n_out, 3))
    data = np.vstack([matched, outliers])
    mp = rng.integers(0, 9, nm).astype(np.int32)
    dp = np.concatenate([mp[sel], rng.integers(0, 9, n_out)]).astype(
        np.int32)
    perm = rng.permutation(len(data))
    return (np.round(data[perm], 6), np.round(model, 6),
            dp[perm].copy(), mp)


def synthetic_pool_trimmed(n: int, seed: int = 23):
    """Noisy/outlier raw pairs for the trimmed (dissimilar-style) bench
    workload; tools/ref_workload_baseline.py --trimmed runs the reference
    binary on the same clouds with the same trimFraction."""
    rng = np.random.default_rng(seed)
    return [(f"trm{i:02d}",) + _synthetic_pair_noisy(rng)
            for i in range(n)]


def normalized_synthetic(entry):
    """Raw synthetic pair -> the normalized quantized clouds the engine
    registers (identical to what the reference binary computes from the
    same .mol2: centralize each, common scale, 6-sig-digit file round-trip
    — jly_main.cpp:83-99)."""
    from goicp_tpu.geom.normalize import normalize_pair
    from goicp_tpu.io.xyz import quantize_like_file

    _, data, model, dp, mp = entry
    norm = normalize_pair(data, model)
    return (quantize_like_file(norm["source"]),
            quantize_like_file(norm["target"]), dp, mp)


def _bucket_and_prepare(raw, cfg):
    from goicp_tpu.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                            prepare_pair)
    dims: dict = {}
    for data, model, _, _ in raw:
        d = bucket_dims(model, len(data), len(model), cfg)
        dims = {k: max(dims.get(k, 0), v) for k, v in d.items()}
    return [make_count_dynamic(
        prepare_pair(data, model, dp, mp, cfg, **dims))
        for data, model, dp, mp in raw]


def bucket_and_prepare_multi(raw, cfg, max_buckets: int = 3):
    """Shape-BUCKETED prep: pairs grouped by their own dims
    (prepare.plan_buckets) instead of one pool-max bucket.  One fused
    stream runs per bucket; trajectories are padding-invariant so per-pair
    results and eval counts are IDENTICAL to the single-bucket protocol
    (tests/test_bucketing.py).  Returns [(pairs, original_indices)]."""
    from goicp_tpu.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                            plan_buckets, prepare_pair)
    dims_list = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raw]
    plan = plan_buckets(dims_list, max_buckets=max_buckets)
    return [([make_count_dynamic(prepare_pair(*raw[i], cfg, **bd))
              for i in idxs], idxs) for bd, idxs in plan]


def reassemble(outs, n: int):
    """[(original_indices, DeviceResult batch)] -> DeviceResult rows in
    original pair order (the per-bucket streams' inverse permutation)."""
    from goicp_tpu.search.device_engine import DeviceResult
    rows = [None] * n
    for idxs, out in outs:
        for j, i in enumerate(idxs):
            rows[i] = tuple(np.asarray(getattr(out, f))[j]
                            for f in DeviceResult._fields)
    return DeviceResult(*(np.stack([r[k] for r in rows])
                          for k in range(len(DeviceResult._fields))))


def _similar_raw(cfg, n_total: int = BATCH):
    raw = [_load_real_pair("2x86_3", "1eq2_6", cfg),    # BO1 pair 1
           _load_real_pair("2ktd_1", "4imo_2", cfg)]    # BO1 pair 2
    raw += [normalized_synthetic(e)
            for e in synthetic_pool(n_total - len(raw))]
    return raw


def build_batch(cfg, n_total: int = BATCH):
    """The two real golden pairs + synthetic fill, shape-bucketed together
    and made dynamic-count so they share one compiled program."""
    return _bucket_and_prepare(_similar_raw(cfg, n_total), cfg)


def build_batch_buckets(cfg, n_total: int = BATCH, max_buckets: int = 3):
    """The similar workload, shape-bucketed into up to max_buckets groups
    (see _bucket_and_prepare_multi) -> [(pairs, original_indices)]."""
    return bucket_and_prepare_multi(_similar_raw(cfg, n_total), cfg,
                                     max_buckets)


def build_trimmed_batch(cfg, n_total: int = TRIM_BATCH):
    """The trimmed (dissimilar-style) workload: noisy/outlier synthetic
    pairs registered with trimFraction=TRIM_FRACTION (the reference's
    dissimilar-batch setting, bo1_GoICP.py:56-68 + READMEGo-ICP.md:82-84).
    cfg must already carry trimFraction=TRIM_FRACTION."""
    raw = [normalized_synthetic(e)
           for e in synthetic_pool_trimmed(n_total)]
    return _bucket_and_prepare(raw, cfg)


def build_trimmed_batch_buckets(cfg, n_total: int = TRIM_BATCH,
                                max_buckets: int = 3):
    """Trimmed workload, shape-bucketed -> [(pairs, original_indices)]."""
    raw = [normalized_synthetic(e)
           for e in synthetic_pool_trimmed(n_total)]
    return bucket_and_prepare_multi(raw, cfg, max_buckets)


def check_converged_with_margin(out, cfg, batch_pairs):
    """Every pair converged, and (margin guard) every converged gap sits
    at least (1 - margin_frac) below the reported epsilon, so a numeric
    perturbation cannot flip a benched pair to unconverged."""
    conv = np.asarray(out.converged)
    assert bool(conv.all()), f"unconverged pairs: {np.where(~conv)[0]}"
    if cfg.margin_frac < 1.0:
        gap = np.asarray(out.gap)
        for i, p in enumerate(batch_pairs):
            eps_i = cfg.MSEThresh * float(np.asarray(p.counts[1]))
            # 1e-3 tolerance: converged gaps land JUST under the tightened
            # threshold by construction, so an exact-boundary assert would
            # itself be numerically flaky; the headroom being proven
            # ((1-margin_frac)*eps ~ 0.25) dwarfs the tolerance
            assert gap[i] <= cfg.margin_frac * eps_i + 1e-3, \
                (i, float(gap[i]), eps_i)


def _check_parity(out, cfg, batch_pairs):
    """Golden parity on the real pairs inside the measured batch, plus the
    convergence-margin guard on every pair."""
    err = np.asarray(out.error)
    comp = np.asarray(out.opt_comp)
    nd1 = batch_pairs[0].counts[0]
    eps = cfg.MSEThresh * float(nd1)          # the reference's own epsilon
    check_converged_with_margin(out, cfg, batch_pairs)
    assert abs(float(err[0]) - 8.45388) < eps, \
        f"pair-1 parity failed: error={float(err[0])}"
    # compat can flip by one correspondence across backends (f32 tie-breaks)
    assert abs((int(nd1) - int(comp[0])) - 133) <= 2, int(comp[0])


def run_pool(buckets, cfg):
    """One fused stream per shape bucket -> [(original_indices, result)]."""
    from goicp_tpu.search.fused_stream import register_fused_stream
    return [(idxs, register_fused_stream(bp, cfg, width=FUSED_WIDTH,
                                         chunk_steps=FUSED_CHUNK))
            for bp, idxs in buckets]


def in_pool_order(buckets, n: int) -> list:
    """Prepared pairs of a bucketed pool, in original pair order."""
    ordered = [None] * n
    for bp, idxs in buckets:
        for j, i in enumerate(idxs):
            ordered[i] = bp[j]
    return ordered


def measure() -> dict:
    """Both workloads, warmed, best of 2 steady-state runs each."""
    import dataclasses

    from goicp_tpu.config import GoICPConfig

    cfg = bench_shape(GoICPConfig.from_file(f"{REF}/config.txt"))

    buckets = build_batch_buckets(cfg, BATCH, max_buckets=SIMILAR_BUCKETS)
    ordered_pairs = in_pool_order(buckets, BATCH)
    out = reassemble(run_pool(buckets, cfg), BATCH)   # warm (compile)
    _check_parity(out, cfg, ordered_pairs)
    wall = float("inf")
    evals = 0
    for _ in range(2):
        t0 = time.time()
        outs = run_pool(buckets, cfg)
        w = time.time() - t0
        out = reassemble(outs, BATCH)
        if w < wall:
            wall = w
            evals = int(np.sum(np.asarray(out.evals)))
        _check_parity(out, cfg, ordered_pairs)

    # second workload: trimmed dissimilar-style (BASELINE.json config 4),
    # noisy/outlier pairs registered with trimFraction
    cfg_t = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                trans_capacity=TRIM_CAPACITY)
    tbuckets = build_trimmed_batch_buckets(cfg_t, TRIM_BATCH, TRIM_BUCKETS)
    run_pool(tbuckets, cfg_t)                          # warm
    twall = float("inf")
    for _ in range(2):
        t0 = time.time()
        touts = run_pool(tbuckets, cfg_t)
        twall = min(twall, time.time() - t0)
        tout = reassemble(touts, TRIM_BATCH)
        conv = np.asarray(tout.converged)
        assert conv.all(), f"unconverged trimmed pairs: {np.where(~conv)[0]}"

    return {"pairs_per_s": BATCH / wall, "bound_evals_per_s": evals / wall,
            "wall_s": wall, "batch": BATCH,
            "trimmed_pairs_per_s": TRIM_BATCH / twall,
            "trimmed_batch": TRIM_BATCH, "trimmed_wall_s": twall}


if __name__ == "__main__":
    print(json.dumps(measure()))


def demo_scale_clouds(seed: int, n_model: int = 35947, n_data: int = 1000):
    """A demo-scale plain registration problem (the Stanford bunny demo's
    sizes: a 35,947-point model, a 1,000-point data cloud), generated.

    The model is a seeded animal-like surface: points on five ellipsoids
    (body, head, two ears, tail) at jittered places, normalized into
    [-0.9, 0.9]^3 like the demo's clouds.  It has no rotational symmetry,
    so a wrong pose leaves many points far from the surface and the
    epsilon-optimal registration is the true one.  The data cloud is a
    rigid transform of n_data model points, rotated by 2.0-2.8 rad.
    Returns (model (Nm,3), data (Nd,3), truth (Nd,3)) where truth[i] is
    the model point data[i] was made from."""
    from goicp_tpu.geom.rotation import rodrigues_np

    rng = np.random.default_rng(seed)
    # (center, radii) of body, head, ears, tail
    lobes = np.array([
        [0.00, 0.00, 0.00, 0.50, 0.35, 0.30],
        [0.45, 0.25, 0.10, 0.22, 0.20, 0.20],
        [0.50, 0.55, 0.20, 0.06, 0.20, 0.05],
        [0.36, 0.55, -0.05, 0.06, 0.18, 0.05],
        [-0.52, 0.05, -0.10, 0.10, 0.10, 0.10],
    ])
    lobes = lobes * rng.uniform(0.9, 1.1, lobes.shape)
    area = np.prod(lobes[:, 3:], axis=1) ** (2.0 / 3.0)
    which = rng.choice(len(lobes), n_model, p=area / area.sum())
    u = rng.uniform(-1.0, 1.0, n_model)
    phi = rng.uniform(0.0, 2.0 * np.pi, n_model)
    s = np.sqrt(1.0 - u * u)
    dirs = np.stack([s * np.cos(phi), s * np.sin(phi), u], axis=1)
    model = lobes[which, :3] + dirs * lobes[which, 3:]
    model += rng.normal(0.0, 0.002, model.shape)
    model -= (model.min(0) + model.max(0)) / 2.0
    model *= 0.9 / np.abs(model).max()
    # a large rotation: ICP from the identity alone does not find it
    axis = rng.normal(size=3)
    R = rodrigues_np(axis / np.linalg.norm(axis) * rng.uniform(2.0, 2.8))
    tv = rng.uniform(-0.2, 0.2, 3)
    truth = model[rng.permutation(n_model)[:n_data]]
    data = (truth - tv) @ R
    return model, data, truth
