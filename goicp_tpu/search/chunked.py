"""Chunked batched registration: convergence compaction + checkpoint/resume.

The one-dispatch batched engine (register_device_batch) runs its vmapped
while_loop until the SLOWEST pair converges — on a mixed BO1 batch one hard
pair (thousands of outer steps) drags 63 converged lanes along as dead
FLOPs.  Here the batch advances in chunks of `chunk_steps` outer
iterations; between chunks the host reads ONLY the convergence flags,
retires converged pairs, and compacts the survivors into the next
power-of-two bucket (64 -> 32 -> ... -> 1), so the tail of a hard pair
runs at batch size 1 instead of 64.  One XLA compilation per bucket size,
reused across chunks and sweeps.

Because the carried state is an explicit pytree (device_engine.device_init
/ device_run_chunk / device_finalize), a chunk boundary is also a
checkpoint: save_state/load_state serialize the mid-search state of every
in-flight pair, and a killed run resumes to the identical optimum (the
search is deterministic).  The reference has no checkpointing at all; its
closest analogue is per-pair idempotent output files (bo1_GoICP.py:49-51).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.search.device_engine import (DeviceResult, device_finalize,
                                            device_init, device_run_chunk)


@functools.lru_cache(maxsize=32)
def _binit(cfg: GoICPConfig):
    return jax.jit(jax.vmap(lambda p: device_init(p, cfg)))


@functools.lru_cache(maxsize=32)
def _bchunk(cfg: GoICPConfig):
    return jax.jit(jax.vmap(
        lambda p, s, n: device_run_chunk(p, cfg, s, n),
        in_axes=(0, 0, None)))


@functools.lru_cache(maxsize=4)
def _bfin():
    return jax.jit(jax.vmap(device_finalize))


def _next_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _take(tree, idx: np.ndarray):
    return jax.tree_util.tree_map(lambda x: x[jnp.asarray(idx)], tree)


def save_state(path: str, state: dict, active_idx: np.ndarray,
               done: dict[int, tuple]) -> None:
    """Serialize an in-flight batch: per-row search state + the original
    row index of each active lane + already-retired results."""
    blob = {f"state_{k}": np.asarray(v) for k, v in state.items()}
    blob["active_idx"] = np.asarray(active_idx, np.int64)
    blob["done_idx"] = np.asarray(sorted(done.keys()), np.int64)
    for f in DeviceResult._fields:
        blob[f"done_{f}"] = np.stack(
            [np.asarray(getattr(done[i], f)) for i in sorted(done.keys())]) \
            if done else np.zeros((0,))
    np.savez(path, **blob)


def load_state(path: str):
    """-> (state dict, active_idx, done {orig_row: DeviceResult})."""
    with np.load(path) as z:
        state = {k[len("state_"):]: jnp.asarray(z[k])
                 for k in z.files if k.startswith("state_")}
        active_idx = z["active_idx"]
        done_idx = z["done_idx"]
        done = {}
        for j, i in enumerate(done_idx):
            done[int(i)] = DeviceResult(
                *(z[f"done_{f}"][j] for f in DeviceResult._fields))
    return state, active_idx, done


def register_device_batch_compact(pairs, cfg: GoICPConfig,
                                  chunk_steps: int = 256,
                                  mesh=None,
                                  checkpoint_path: str | None = None,
                                  resume: bool = False,
                                  max_chunks: int | None = None,
                                  pad_to: int | None = None):
    """Register a same-bucket batch with convergence compaction.

    Returns a DeviceResult with a leading batch axis in the ORIGINAL pair
    order.  checkpoint_path: save the in-flight state after every chunk;
    resume=True restarts from that file (same pairs, cfg).  max_chunks
    bounds the number of chunks executed (for checkpoint tests); if hit,
    the in-flight state is saved and a partial RuntimeError is raised.
    pad_to: round the batch up by repeating row 0, with the pad rows'
    initial state pre-converged — they never search and retire at the
    first compaction, so every sweep chunk reuses the same-bucket
    compilation (no tail-chunk duplicate work).
    """
    from goicp_tpu.dist.mesh import stack_pairs
    import os

    B = len(pairs)
    n_pad = max(0, (pad_to or B) - B)
    stacked_all = stack_pairs(list(pairs) + [pairs[0]] * n_pad)

    done: dict[int, DeviceResult] = {}
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, active_idx, done = load_state(checkpoint_path)
        cur_pair = _take(stacked_all, active_idx)
    else:
        active_idx = np.arange(B + n_pad)
        cur_pair = stacked_all
        state = None

    def _shard(tree):
        if mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(tree, NamedSharding(mesh, P("data")))

    cur_pair = _shard(cur_pair)
    if state is None:
        state = _binit(cfg)(cur_pair)
        if n_pad:
            pad_mask = jnp.arange(B + n_pad) >= B
            state["converged"] = state["converged"] | pad_mask

    # geometric chunk schedule: early chunks are short so quickly-converging
    # pairs retire (and the batch compacts) before long tail chunks begin;
    # `steps` is traced, so every chunk size reuses the bucket's compilation
    def _sched(i: int) -> int:
        return min(chunk_steps, 16 * (4 ** i))

    chunks = 0
    while True:
        state = _bchunk(cfg)(cur_pair, state,
                             np.int32(_sched(chunks)))
        chunks += 1
        conv = np.asarray(state["converged"])
        its = np.asarray(state["it"])
        finished = conv | (its >= cfg.max_outer_steps)

        if finished.all():
            res = jax.device_get(_bfin()(state))
            for row, orig in enumerate(active_idx):
                if int(orig) not in done:
                    done[int(orig)] = jax.tree_util.tree_map(
                        lambda x: x[row], res)
            break

        n_act = int((~finished).sum())
        bucket = _next_bucket(n_act)
        if bucket < len(active_idx):
            # retire finished rows, compact survivors to the next bucket
            res = jax.device_get(_bfin()(state))
            for row, orig in enumerate(active_idx):
                if finished[row]:
                    done[int(orig)] = jax.tree_util.tree_map(
                        lambda x: x[row], res)
            rows = np.where(~finished)[0]
            take = np.concatenate(
                [rows, np.repeat(rows[:1], bucket - n_act)])
            cur_pair = _shard(_take(cur_pair, take))
            state = _shard(_take(state, take))
            active_idx = active_idx[rows]
            active_idx = np.concatenate(
                [active_idx, np.repeat(active_idx[:1], bucket - n_act)])
            # padded duplicate rows: first survivor repeated; its result is
            # identical (deterministic search), so retirement order is safe

        if checkpoint_path:
            save_state(checkpoint_path, jax.device_get(state), active_idx,
                       done)
        if max_chunks is not None and chunks >= max_chunks:
            if checkpoint_path:
                save_state(checkpoint_path, jax.device_get(state),
                           active_idx, done)
            raise RuntimeError(
                f"max_chunks={max_chunks} reached with "
                f"{int((~finished).sum())} pairs in flight "
                f"(state checkpointed)")

    rows = [done[i] for i in range(B)]
    return DeviceResult(*(np.stack([np.asarray(getattr(r, f))
                                    for r in rows])
                          for f in DeviceResult._fields))


def register_device_stream(pairs, cfg: GoICPConfig, width: int = 8,
                           chunk_steps: int = 32):
    """Round-2 lockstep stream, RETIRED as an engine:
    now a thin adapter over the cross-pair fused stream
    (search/fused_stream.register_fused_stream), which supersedes it —
    same continuous-batching window/refill contract and per-pair results
    identical to register_device, WITHOUT the lockstep coupling (a chunk
    of the old engine cost max-over-window inner iterations per outer
    step).  Kept so round-2 call sites and the equality tests against
    the device engine keep running on one shared implementation.

    Returns DeviceResult with the batch axis in original pair order.
    """
    from goicp_tpu.search.fused_stream import register_fused_stream
    return register_fused_stream(pairs, cfg, width=width,
                                 chunk_steps=max(chunk_steps, 64))
