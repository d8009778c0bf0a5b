"""Slot-gathered outer transitions (cfg.trans_slots):
the fused stream serves at most K transitioning pairs per event
(gather K rows -> vmapped harvest/ICP/advance -> scatter) instead of
paying the block at full window width.  A pair past the K budget waits
with its completed (idempotent) inner state, so each pair's OWN pop
sequence is unchanged — per-pair results must stay EQUAL to the
unslotted engines and to register_device."""

import dataclasses

import numpy as np
import jax

from goicp_tpu.search.device_engine import register_device
from tests.test_device_engine import _cfg, _pair


def _pairs(cfg, seeds=(3, 5, 7, 9)):
    out = []
    for s in seeds:
        p, *_ = _pair(cfg, seed=s, pad=True)
        out.append(p)
    return out


def test_fused_slotted_matches_device():
    from goicp_tpu.search.fused_stream import register_fused_stream
    cfg = _cfg(MSEThresh=0.01, regularization=0.0005, ponderation=1,
               distTransSize=16, rot_batch=1, trans_pop=2,
               trans_capacity=32, trans_slots=2)
    pairs = _pairs(cfg)
    out = register_fused_stream(pairs, cfg, width=4, chunk_steps=64)
    for i, p in enumerate(pairs):
        single = jax.device_get(register_device(p, cfg))
        assert float(np.asarray(out.error)[i]) == float(single.error)
        assert int(np.asarray(out.evals)[i]) == int(single.evals)
        assert int(np.asarray(out.outer_iters)[i]) == \
            int(single.outer_iters)


def test_fused_slotted_equals_unslotted():
    from goicp_tpu.search.fused_stream import register_fused_stream
    cfg0 = _cfg(MSEThresh=0.01, regularization=0.0005, ponderation=1,
                distTransSize=16, rot_batch=1, trans_pop=2,
                trans_capacity=32)
    pairs = _pairs(cfg0)
    cfg1 = dataclasses.replace(cfg0, trans_slots=1)
    o0 = register_fused_stream(pairs, cfg0, width=4, chunk_steps=64)
    o1 = register_fused_stream(pairs, cfg1, width=4, chunk_steps=64)
    np.testing.assert_array_equal(np.asarray(o0.error),
                                  np.asarray(o1.error))
    np.testing.assert_array_equal(np.asarray(o0.evals),
                                  np.asarray(o1.evals))
    np.testing.assert_array_equal(np.asarray(o0.opt_comp),
                                  np.asarray(o1.opt_comp))
