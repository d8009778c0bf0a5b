"""Shape-bucketed pool planning (pipeline.prepare.plan_buckets) and the
bucketed fused streams' equality with the single pool-max bucket.

A single pool-max bucket pads every pair to the pool max, and the padded
work is paid on every bound evaluation.  Bucketing only changes padding,
and every bound/trim/chem/ICP path is padding-invariant, so per-pair
results and eval counts must be IDENTICAL (tools/bucket_study.py checks
the same at bench scale).
"""

import numpy as np
import pytest

from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues_np
from goicp_tpu.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                        plan_buckets, prepare_pair)


def _raw(seed, n, m):
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, size=(m, 3))
    R = rodrigues_np(rng.uniform(-1.5, 1.5, 3))
    tv = rng.uniform(-0.1, 0.1, 3)
    data = (model[:n] - tv) @ R
    dp = rng.integers(0, 9, n).astype(np.int32)
    mp = rng.integers(0, 9, m).astype(np.int32)
    return data, model, dp, mp


def test_plan_buckets_partition_and_domination():
    cfg = GoICPConfig(distTransSize=14)
    raws = [_raw(s, 24 + 8 * (s % 5), 30 + 8 * (s % 4)) for s in range(12)]
    dims = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raws]
    plan = plan_buckets(dims, max_buckets=3, min_per_bucket=2)
    seen = sorted(i for _, idxs in plan for i in idxs)
    assert seen == list(range(12))                    # exact partition
    for bd, idxs in plan:
        for i in idxs:
            # every member's dims fit inside its bucket's dims
            assert all(bd[k] >= dims[i][k] for k in bd)
    assert 1 <= len(plan) <= 3


def test_plan_buckets_collapses_small_pools():
    cfg = GoICPConfig(distTransSize=10)
    raws = [_raw(s, 24, 30) for s in range(3)]
    dims = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raws]
    plan = plan_buckets(dims, max_buckets=4, min_per_bucket=4)
    assert len(plan) == 1 and sorted(plan[0][1]) == [0, 1, 2]


def test_plan_buckets_merges_identical_dims():
    cfg = GoICPConfig(distTransSize=10)
    raws = [_raw(s, 24, 30) for s in range(8)]        # all same sizes
    dims = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raws]
    plan = plan_buckets(dims, max_buckets=4, min_per_bucket=1)
    assert len(plan) == 1                             # groups collapse


@pytest.mark.slow
def test_bucketed_streams_match_single_bucket():
    from goicp_tpu.search.fused_stream import register_fused_stream
    cfg = GoICPConfig(MSEThresh=0.001, regularization=0.0005, ponderation=0,
                      distTransSize=12, rot_batch=1, trans_capacity=64,
                      trans_pop=4, inner_max_iters=60, max_outer_steps=200)
    raws = [_raw(s, 20 + 6 * s, 26 + 8 * s) for s in range(4)]
    dims = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raws]

    pool = {k: max(d[k] for d in dims) for k in dims[0]}
    single = [make_count_dynamic(prepare_pair(*r, cfg, **pool))
              for r in raws]
    out1 = register_fused_stream(single, cfg, width=2, chunk_steps=16)

    plan = plan_buckets(dims, max_buckets=2, min_per_bucket=2)
    assert len(plan) == 2
    errs = np.zeros(4)
    evs = np.zeros(4, np.int64)
    for bd, idxs in plan:
        bp = [make_count_dynamic(prepare_pair(*raws[i], cfg, **bd))
              for i in idxs]
        o = register_fused_stream(bp, cfg, width=2, chunk_steps=16)
        for j, i in enumerate(idxs):
            errs[i] = float(np.asarray(o.error)[j])
            evs[i] = int(np.asarray(o.evals)[j])
    np.testing.assert_allclose(errs, np.asarray(out1.error),
                               rtol=1e-6, atol=1e-7)
    assert evs.tolist() == np.asarray(out1.evals).astype(np.int64).tolist()
