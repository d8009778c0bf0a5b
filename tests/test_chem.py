"""Chemistry: properties, compatibility, neighbor weights."""

import numpy as np

from goicp_tpu.chem.neighbors import (adaptive_neighbor_counts,
                                      neighbor_counts, neighbor_weights)
from goicp_tpu.chem.properties import (NUM_PROPS, PROP_CODES,
                                       codes_to_indices,
                                       compatibility_matrix, string_to_prop)


def test_prop_codes():
    assert string_to_prop("OG") == 8204959
    assert string_to_prop("C") == 1
    assert string_to_prop("???") == PROP_CODES["OG"]  # fallback
    idx = codes_to_indices(np.array([8204959, 1, 30894]))
    np.testing.assert_array_equal(idx, [0, 8, 1])


def test_compat_identity():
    m = compatibility_matrix()
    assert m.shape == (NUM_PROPS, NUM_PROPS)
    np.testing.assert_array_equal(m, np.eye(NUM_PROPS, dtype=bool))


def test_compat_rich():
    m = compatibility_matrix(identity_only=False)
    from goicp_tpu.chem.properties import PROP_INDEX
    assert m[PROP_INDEX["N"], PROP_INDEX["NZ"]]
    assert not m[PROP_INDEX["N"], PROP_INDEX["O"]]


def test_neighbor_counts_simple():
    # three collinear points, spacing 0.1; sqrt(0.05)~0.2236
    pts = np.array([[0, 0, 0], [0.1, 0, 0], [0.2, 0, 0]], dtype=float)
    c = neighbor_counts(pts, 0.050)
    np.testing.assert_array_equal(c, [2, 2, 2])
    c2 = neighbor_counts(pts, 0.0001)  # radius 0.01
    np.testing.assert_array_equal(c2, [0, 0, 0])


def test_adaptive_counts_and_weights():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, size=(120, 3))
    counts, min_n, r = adaptive_neighbor_counts(pts)
    assert counts.max() >= 19
    assert r >= 0.035
    w = neighbor_weights(pts)
    assert w.shape == (120,)
    assert (w >= 1.0).all()
    # sparsest points get the largest weights
    assert w[counts.argmin()] == w.max()


def test_trimmed_compat_count_matches_reference_semantics():
    """Trimmed-run compatibility counting parity.

    The reference counts incompatibilities over the ICP's stored
    correspondence arrays (countCompatibilities, jly_goicp.cpp:890-914);
    on trimmed runs those arrays were qsorted by NN distance
    (jly_icp3d.hpp:252-255) — but the qsort only PERMUTES the Nd
    (id_data, id_model) entries, so the count over them is
    order-invariant and equals the full-cloud final-NN count our
    icp_chem_terms computes.  This test emulates the reference loop
    (sort pairs by distance, count over all Nd in sorted order) and
    asserts equality with our path on a trimmed run."""
    import numpy as np

    from goicp_tpu.bounds.error import icp_chem_terms
    from goicp_tpu.chem.properties import compatibility_matrix
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.geom.rotation import rodrigues_np
    from goicp_tpu.icp.icp import icp_run
    from goicp_tpu.pipeline.prepare import prepare_pair
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    cfg = GoICPConfig(regularization=0.0005, ponderation=1,
                      distTransSize=12, trimFraction=0.2)
    nm = 60
    model = rng.uniform(-0.7, 0.7, size=(nm, 3))
    R = rodrigues_np(rng.uniform(-1, 1, 3))
    sel = rng.permutation(nm)[:45]
    data = (model[sel] + rng.normal(0, 0.004, (45, 3))) @ R
    # a few outliers the trim must reject
    data[:5] = rng.uniform(-0.9, 0.9, size=(5, 3))
    mp = rng.integers(0, 9, nm).astype(np.int32)
    dp = mp[sel].copy()
    pair = prepare_pair(data, model, dp, mp, cfg)
    assert pair.inlier_num < pair.n_data        # trimming active

    r = icp_run(pair.data, pair.model, jnp.eye(3), jnp.zeros(3),
                inlier_num=pair.inlier_num, max_iter=100,
                err_diff=cfg.err_diff)
    *_, ours = icp_chem_terms(pair, cfg, r.nn_idx)

    # reference emulation: transform with the PRE-update transform of the
    # last ICP iteration (the stored arrays' transform == the returned
    # correspondences' transform), qsort pairs by NN distance, count
    # incompatibilities over ALL Nd sorted entries
    nn = np.asarray(r.nn_idx)
    pts = np.asarray(pair.data) @ np.asarray(r.R).T + np.asarray(r.t)
    d2 = np.sum((pts - np.asarray(pair.model)[nn]) ** 2, axis=1)
    order = np.argsort(d2, kind="stable")       # the qsort permutation
    compat = np.asarray(compatibility_matrix())
    not_comp = 0
    for i in order:                              # all Nd entries
        if not compat[dp[i], mp[nn[i]]]:
            not_comp += 1
    assert int(ours) == not_comp
