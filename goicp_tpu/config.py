"""Configuration for the Go-ICP registration engine.

Keeps the reference's config keys with identical names and defaults so a
reference `config.txt` drives a parity run unchanged
(reference: jly_main.cpp:231-270, ConfigMap.cpp, config.txt).

Extra keys (absent from the reference) control the search shape: batch
sizes, frontier capacities, iteration caps.  They only affect speed / pruning
efficiency, never epsilon-optimality: lower bounds of nodes dropped by
capacity are folded back into the reported bound (see search/inner.py).
"""

from __future__ import annotations

import dataclasses
import re


# the keys of the reference's config.txt, in its order (jly_main.cpp:231-270)
REFERENCE_KEYS = ("MSEThresh", "norm", "regularization",
                  "regularizationNeighbors", "ponderation", "cfpfh",
                  "regularizationFPFH", "rotMinX", "rotMinY", "rotMinZ",
                  "rotWidth", "transMinX", "transMinY", "transMinZ",
                  "transWidth", "trimFraction", "distTransSize",
                  "distTransExpandFactor")


@dataclasses.dataclass(frozen=True)
class GoICPConfig:
    # ---- reference keys (config.txt:1-54) ----
    MSEThresh: float = 0.01
    norm: int = 2                    # 1 = L1, 2 = L2
    regularization: float = 0.0005   # chem incompatibility weight
    regularizationNeighbors: float = 0.0
    ponderation: int = 1             # 1 = weight points by 1 + 2*minN/neighbors
    cfpfh: int = 0                   # 0 off, 1 = bins 0..40, 2 = 0..32, 3 = 33..40
    regularizationFPFH: float = 0.0
    rotMinX: float = -3.1416
    rotMinY: float = -3.1416
    rotMinZ: float = -3.1416
    rotWidth: float = 6.2832
    transMinX: float = -0.5
    transMinY: float = -0.5
    transMinZ: float = -0.5
    transWidth: float = 1.0
    trimFraction: float = 0.0
    distTransSize: int = 20
    distTransExpandFactor: float = 2.0

    # ---- search shape (new; no reference equivalent) ----
    rot_batch: int = 8           # rotation cubes popped per outer step
    trans_capacity: int = 128    # translation frontier width per rotation lane
    trans_pop: int = 8           # translation nodes expanded per inner iteration
    inner_max_iters: int = 200   # inner BnB iteration cap per invocation
    rot_frontier_capacity: int = 500_000  # host-side outer frontier cap
    device_rot_capacity: int = 2048  # device-engine outer frontier cap
    icp_max_iter: int = 200      # reference caps at 10000 (jly_icp3d.hpp:126);
                                 # ICP converges in <50 iters on these clouds
    max_outer_steps: int = 100_000
    icp_seeds: int = 1           # device engine: ICP the top-K ub lanes per
                                 # outer step (the host engine ICPs every
                                 # improving lane, jly_goicp.cpp:771-854;
                                 # K>1 recovers that quality at small
                                 # rot_batch for a fraction of the lanes)
    margin_frac: float = 1.0     # <1 tightens the epsilon used for the
                                 # stop rule AND per-node threshold
                                 # discard to margin_frac*MSEThresh*N:
                                 # converged gaps then carry 1-margin_frac
                                 # headroom below the reference's epsilon
                                 # (guards the near-epsilon flakiness a
                                 # numeric perturbation could flip; the
                                 # result is still epsilon-optimal under
                                 # the ORIGINAL epsilon, just searched a
                                 # little deeper)
    icp_on_improve: int = 1      # 1 = device/sharded engines run ICP only
                                 # on improving outer steps (the reference's
                                 # own gating, jly_goicp.cpp:771-854); 0 =
                                 # round-2 behavior (every step — costs
                                 # sequential NN+SVD latency per step)
    fused_inner: int = 1         # 1 = one fused inner search per outer step
                                 # (ub+lb from a single DT lookup; halves the
                                 # bound work at identical epsilon guarantees)
    lane_compaction: int = 1     # 1 = staged inner-lane compaction
                                 # (L -> L/2 -> L/4): done lanes are gathered
                                 # out of the evaluated batch; bit-identical
                                 # per-lane results, less masked work
    init_seeds: int = 1          # initial-incumbent ICP multi-start: 1 =
                                 # identity only (the reference's seeding,
                                 # jly_goicp.cpp:629-661); K>1 also ICPs
                                 # from K-1 fixed coarse rotations (vmapped
                                 # — one ICP latency total) and adopts the
                                 # best.  A tighter first incumbent prunes
                                 # superlinearly (better incumbents
                                 # collapse outer steps); purely
                                 # an incumbent improvement, epsilon-
                                 # optimality and final quality unchanged
    chem_reuse: int = 0          # 1 = corner reuse: every frontier node
                                 # carries the chem values of its own 8
                                 # cube corners (computed when it was
                                 # inserted as a child), so a pop's 3x3x3
                                 # corner lattice only needs the 19 NEW
                                 # points from the kernel — 0.70x the chem
                                 # kernel volume (the bandwidth-bound hot
                                 # op).  Values are identical (the even
                                 # lattice positions are float-identical
                                 # to the stored corners' positions up to
                                 # the 1-ulp chained-add case, which only
                                 # matters if it crosses a voxel-rounding
                                 # boundary — measure-zero in practice and
                                 # epsilon-legal always).  The batched-
                                 # array analogue of the reference's
                                 # per-translation memo caches
                                 # (jly_goicp.h:99-109).  Ignored under
                                 # chem_survivors (two-phase) mode.
    trans_slots: int = 0         # fused stream: serve at most K
                                 # transitioning pairs per outer-transition
                                 # event (gather K rows -> transition ->
                                 # scatter back) instead of running the
                                 # vmapped harvest/ICP/advance block at
                                 # full window width W every time ANY pair
                                 # transitions.  0 = full width.  A pair
                                 # past the K budget simply waits (its
                                 # completed inner state is idempotent),
                                 # so each pair's OWN trajectory is
                                 # unchanged — per-pair results stay
                                 # equal to register_device (tested)
    sorted_merge: int = 0        # 1 = two-way rank merge for the frontier
                                 # insert (argsort only the 8P children
                                 # block + one pairwise comparison matrix
                                 # against the already-sorted remainder)
                                 # instead of argsorting all C+8P keys;
                                 # output identical (tested) — a pure
                                 # glue-cost experiment, flipped on only
                                 # if the on-chip profile wins
    chem_survivors: int = 0      # two-phase bound evaluation: 0 = chem corner
                                 # terms for EVERY popped parent's 27-lattice
                                 # (the reference evaluates chem
                                 # unconditionally, jly_goicp.cpp:429-550);
                                 # K>0 = evaluate geometry first, then chem
                                 # ONLY for the K lowest-lb children per lane
                                 # that survive the geometric lb against the
                                 # incumbent (8 corners each).  Children past
                                 # the budget keep their geometric lb — a
                                 # valid lower bound — and cannot be adopted
                                 # this iteration (ub = inf), so
                                 # epsilon-optimality is unchanged; with
                                 # K >= 8*trans_pop the trajectory is
                                 # IDENTICAL to the lattice path (tested)

    # ---- derived (jly_main.cpp:258-262) ----
    @property
    def doTrim(self) -> bool:
        return self.trimFraction >= 0.001

    @property
    def err_diff(self) -> float:
        # ICP convergence threshold (jly_goicp.cpp:232)
        return self.MSEThresh / 10000.0

    @property
    def mse_margin(self) -> float:
        # the per-point epsilon the ENGINES search to (stop rule + node
        # threshold discard); reporting/parity keep the plain MSEThresh
        return self.MSEThresh * self.margin_frac

    def validate(self) -> "GoICPConfig":
        assert self.norm in (1, 2), "norm must be 1 (L1) or 2 (L2)"
        assert self.cfpfh in (0, 1, 2, 3)
        assert self.distTransSize >= 2
        assert 0.0 <= self.trimFraction < 1.0
        return self

    def to_file(self, path: str) -> None:
        """Write a reference-style config.txt: every reference key, then
        each extra (search-shape) key whose value is not its default, so
        from_file(path) returns this config."""
        extra = [f.name for f in dataclasses.fields(self)
                 if f.name not in REFERENCE_KEYS
                 and getattr(self, f.name) != f.default]
        with open(path, "w") as fh:
            for k in REFERENCE_KEYS + tuple(extra):
                fh.write(f"{k}={getattr(self, k)}\n")

    @classmethod
    def from_file(cls, path: str) -> "GoICPConfig":
        return cls.from_dict(parse_config_file(path))

    @classmethod
    def from_dict(cls, values: dict) -> "GoICPConfig":
        kwargs = {}
        int_fields = {
            f.name for f in dataclasses.fields(cls) if f.type in ("int", int)
        }
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            raw = values[f.name]
            kwargs[f.name] = int(float(raw)) if f.name in int_fields else float(raw)
        return cls(**kwargs).validate()


def parse_config_file(path: str) -> dict:
    """Parse a reference-style config file: `key=value`, `#` comments.

    Token splitting mirrors ConfigMap.cpp (delimiters " =;").
    """
    values = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"([A-Za-z0-9_]+)\s*[=; ]\s*(\S+)", line)
            if m:
                values[m.group(1)] = m.group(2)
    return values
