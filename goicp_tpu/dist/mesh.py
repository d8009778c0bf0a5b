"""Device-mesh parallelism for the BnB search.

The reference has NO parallelism of any kind (SURVEY.md section 2.4): one
process, one core, one pair at a time; its only scaling is a Python for-loop
over the 383 BO1 pairs.  Here parallelism is first-class:

  * `data` mesh axis — pair-level data parallelism: independent
    registrations run on different devices (the sweep loop, but
    simultaneous).
  * `search` mesh axis — intra-pair search parallelism: the L rotation
    lanes of one outer step (8 children x rot_batch popped cubes) shard
    across devices; each device runs the inner translation BnB for its lane
    slice, and the incumbent/adoption reduction happens on the host (or via
    a jnp.min collective when fused).  This is the rotation-subtree sharding
    of SURVEY.md section 2.4 item 3.

Both are expressed with jax.sharding + NamedSharding over one Mesh; XLA
inserts the collectives.  The mesh follows the algorithm, not a wiring
diagram: the four GPUs of one host are all-to-all over NVLink, so any
(data, search) factorization of them is equally well connected.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from goicp_tpu.config import GoICPConfig
from goicp_tpu.pipeline.prepare import PairData
from goicp_tpu.search.inner import inner_bnb


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-process initialization.

    Call once per process before any jax usage; afterwards `jax.devices()`
    spans every process and `make_mesh` lays `data`×`search` over them.
    Pass the coordinator address (`host:port`), process count and this
    process's id: nothing in a plain GPU cluster lets JAX discover them.
    The reference has no distributed runtime at all (SURVEY.md §2.4)."""
    import jax
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(n_data: int = 1, n_search: int | None = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n_search = n_search or (len(devices) // n_data)
    dev = np.asarray(devices[: n_data * n_search]).reshape(n_data, n_search)
    return Mesh(dev, axis_names=("data", "search"))


def stack_pairs(pairs: list[PairData]) -> PairData:
    """Stack equal-shaped PairData pytrees along a new leading pair axis.

    All pairs must share Nd/Nm and grid padding (use prepare_pair's
    pad_cells/pad_points).  Host-side aux metadata (n_cells, GridGeometry)
    legitimately differs per pair — per-pair geometry travels in the
    device-side `consts` leaf — so we stack leaves under the first pair's
    treedef instead of tree_map (which would reject mismatched aux).
    """
    assert len({p.n_data for p in pairs}) == 1
    assert len({p.n_model for p in pairs}) == 1
    assert len({p.inlier_num for p in pairs}) == 1
    leaves0, treedef = jax.tree_util.tree_flatten(pairs[0])
    all_leaves = [jax.tree_util.tree_leaves(p) for p in pairs]
    assert all(len(lv) == len(leaves0) for lv in all_leaves)
    stacked = [jnp.stack([lv[i] for lv in all_leaves])
               for i in range(len(leaves0))]
    return jax.tree_util.tree_unflatten(treedef, stacked)


def put_global(tree, sharding: NamedSharding):
    """device_put a host-replicated pytree onto a (possibly multi-process)
    sharding.  Within one process this is plain jax.device_put; when the
    mesh spans processes, every process passes the same host value and each
    contributes its addressable shards (jax.make_array_from_callback)."""
    if sharding.is_fully_addressable:
        return jax.device_put(tree, sharding)

    def put(x):
        xnp = np.asarray(x)
        return jax.make_array_from_callback(
            xnp.shape, sharding, lambda idx: xnp[idx])

    return jax.tree_util.tree_map(put, tree)


def sharded_inner_step(mesh: Mesh, cfg: GoICPConfig,
                       with_rot_uncertainty: bool, fused: bool = False):
    """Build a pjit'd, pair-batched, lane-sharded inner-BnB step.

    Returns fn(stacked_pair, pts_rot (Pb,L,Nd,3), widths (Pb,L),
               active (Pb,L), opt_err (Pb,)) -> InnerResult with leading
    (Pb, L) axes; Pb shards over the `data` axis and L over `search`.
    fused=True runs the single-pass ub+lb search (see search/inner.py).
    """
    vmapped = jax.vmap(
        lambda pair, pts, w, act, opt: inner_bnb(
            pair, cfg, pts, w, act, opt,
            with_rot_uncertainty=with_rot_uncertainty, fused=fused))

    pair_sh = NamedSharding(mesh, P("data"))
    lane3_sh = NamedSharding(mesh, P("data", "search"))
    scalar_sh = NamedSharding(mesh, P("data"))

    def fn(stacked_pair, pts_rot, widths, active, opt_err):
        pts_rot = jax.lax.with_sharding_constraint(pts_rot, lane3_sh)
        widths = jax.lax.with_sharding_constraint(widths, lane3_sh)
        active = jax.lax.with_sharding_constraint(active, lane3_sh)
        opt_err = jax.lax.with_sharding_constraint(opt_err, scalar_sh)
        return vmapped(stacked_pair, pts_rot, widths, active, opt_err)

    del pair_sh  # inputs reshard via the constraints inside fn
    return jax.jit(fn)


@functools.partial(jax.jit, static_argnames=("axis",))
def reduce_best(errs: jnp.ndarray, axis: str = "search"):
    """Global min-reduction of incumbent candidates (the collective analogue
    of the scalar optError update at jly_goicp.cpp:771-781)."""
    return jnp.min(errs)
