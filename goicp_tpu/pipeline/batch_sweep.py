"""Batched multi-pair registration: N pairs' BnB searches share the device.

RETIRED as a standalone engine: the round-2
host-coordinated slot machinery this module used to implement (per-slot
Python state, stacked per-step dispatches) is superseded by the
cross-pair fused stream (search/fused_stream.py), which runs the same
continuous-batching window entirely on-device with per-pair results
identical to register_device.  `register_batch` survives as a THIN
ADAPTER with the original contract (list[RegistrationResult] in input
order, static same-bucket pairs, optional pair-DP mesh), so round-2 call
sites and the sequential-equality tests keep running against the one
shared adopt/gap implementation.

Reference anchor: the one-pair-per-process loop bo1_GoICP.py:40-54.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.pipeline.prepare import PairData
from goicp_tpu.search.outer import RegistrationResult


def register_batch(pairs: list[PairData], cfg: GoICPConfig,
                   slots: int | None = None,
                   max_steps: int | None = None,
                   mesh=None) -> list[RegistrationResult]:
    """Register many same-bucket pairs concurrently; results in input
    order.  slots -> the fused stream's window width.  mesh: optional
    Mesh with a `data` axis (width is rounded up to a multiple of it)."""
    from goicp_tpu.pipeline.pair import adapt_device_result
    from goicp_tpu.search.fused_stream import register_fused_stream

    if any(p.dynamic_counts for p in pairs):
        raise ValueError("pass static pairs (make_count_dynamic pairs go "
                         "through register_fused_stream directly)")
    n = len(pairs)
    width = min(slots or n, n)
    if mesh is not None:
        d = mesh.shape["data"]
        width = -(-max(width, d) // d) * d
    run_cfg = cfg if max_steps is None else dataclasses.replace(
        cfg, max_outer_steps=max_steps)
    t0 = time.time()
    out = register_fused_stream(pairs, run_cfg, width=width,
                                chunk_steps=64, mesh=mesh)
    per_pair_s = (time.time() - t0) / n
    rows = []
    for i, pair in enumerate(pairs):
        row = type(out)(*(np.asarray(leaf)[i] for leaf in out))
        rows.append(adapt_device_result(row, pair.n_data, per_pair_s))
    return rows
