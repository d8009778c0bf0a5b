"""Stanford bunny / random-points demo (demo/demo.m).

The demo drives the plain Go-ICP path: clouds already normalized into
[-1,1]^3, no chemistry terms, prefix downsampling of the data cloud
(`./GoICP model_bunny.txt data_bunny.txt 1000 config.txt output.txt`,
demo/demo.m:22; golden output demo/output.txt: 12.365 s on the reference
CPU).
"""

from __future__ import annotations

import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.io.output import write_output
from goicp_tpu.io.xyz import read_point_cloud
from goicp_tpu.pipeline.prepare import prepare_pair
from goicp_tpu.search.outer import RegistrationResult, register

# the demo's config: plain Go-ICP, no chem terms, on the S=300 grid.
# icp_on_improve=0 matters here: with batched pops the best-of-batch ub
# improves rarely, so gated ICP starves and the search grinds ~1M evals;
# ungated, the per-step ICP lands in the global basin within a few steps
# (the reference fires ICP at single-node granularity,
# jly_goicp.cpp:771-854, so its gating never starves).  The search shape
# (rot_batch, trans_pop, trans_capacity) was tuned on earlier hardware and
# is not yet re-tuned for the GPU.
DEMO_CONFIG = GoICPConfig(
    MSEThresh=0.001, regularization=0.0, regularizationNeighbors=0.0,
    ponderation=0, cfpfh=0, regularizationFPFH=0.0,
    trimFraction=0.0, distTransSize=300, distTransExpandFactor=2.0,
    rot_batch=2, trans_pop=8, trans_capacity=128, icp_on_improve=0)


def run_demo(model_file: str, data_file: str, nd_downsampled: int = 1000,
             cfg: GoICPConfig | None = None, output_file: str | None = None,
             verbose: bool = False,
             engine: str = "device") -> RegistrationResult:
    cfg = cfg or DEMO_CONFIG
    model, _ = read_point_cloud(model_file)
    data, _ = read_point_cloud(data_file)
    zeros_m = np.zeros(len(model), np.int32)
    zeros_d = np.zeros(len(data), np.int32)
    pair = prepare_pair(data, model, zeros_d, zeros_m, cfg,
                        nd_downsampled=nd_downsampled)
    if engine == "device":
        from goicp_tpu.pipeline.pair import register_with_device_engine
        reg = register_with_device_engine(pair, cfg)
    else:
        reg = register(pair, cfg, verbose=verbose)
    if output_file:
        write_output(output_file, reg.time_s, reg.R, reg.t, reg.error,
                     reg.compatibilities)
    return reg
