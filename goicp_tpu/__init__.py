"""goicp_tpu — a batched, accelerator-resident globally-optimal point-cloud
registration engine.

A from-scratch JAX/XLA re-design of the capabilities of
guillaumebaldi/Go-ICP-protein-cavities (Go-ICP branch-and-bound over SE(3),
protein-cavity chemistry-aware error terms, BO1 sweep + RMSD evaluation).

Design, not translation:
  * priority-queue BnB        -> batched array frontiers (sort/prune/compact)
  * per-point DT lookup loops -> vectorized gathers over (cubes x points)
  * kd-tree ICP               -> brute-force distance matmul + top_k trim
  * approximate vector EDT    -> exact EDT + nearest-seed fields
  * per-translation memo maps -> precomputed per-(voxel, point) chem tables
  * no parallelism            -> jax.sharding Mesh: pair-level DP + rotation
                                 subtree sharding with collectives

Layer map (mirrors SURVEY.md section 7.1; see ARCHITECTURE.md + PARITY.md):
  io/       mol2 / xyz / cfpfh / tsv parsing and output writers (+ native)
  geom/     normalization, Rodrigues, transforms, rescale identity, RMSD
  chem/     properties, compatibility, neighbor counts/weights, cFPFH
  grid/     exact 3D EDT distance field + nearest-occupied-cell feature fields
  bounds/   batched (cubes x points) lower/upper bound evaluation + scoring
  icp/      batched trimmed ICP with Kabsch/SVD updates (lax.while_loop)
  search/   inner/outer BnB; host-streaming engine (checkpointable) and the
            fully device-side engines (one XLA dispatch per registration,
            and the cross-pair fused stream)
  dist/     device-mesh sharding: pair DP, subtree sharding, collectives
  pipeline/ pair runner, BO1 sweep, batched multi-pair engine, demo, plots
  native/   C++ host runtime (batched frontier heap, parsers) via ctypes
"""

__version__ = "0.1.0"

import os as _os

CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _place_compile_cache() -> None:
    """Persistent XLA compilation cache.  Sweeps compile one program per
    shape bucket, and every process would otherwise compile them again.

    JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and no
    directory is set here.  Otherwise the cache is CACHE_DIR, a fixed
    directory inside the checkout: the path is part of the cache's key, so
    it must not move between runs.  The cache stays off when the platform
    is pinned to XLA:CPU (JAX_PLATFORMS=cpu, the test backend): CPU
    entries are host-ISA specific, and entries written on a host of
    another CPU generation have crashed the process that loaded them."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if _os.environ.get("JAX_PLATFORMS", "").split(",")[0] == "cpu":
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_place_compile_cache()

from goicp_tpu.config import GoICPConfig  # noqa: F401, E402
