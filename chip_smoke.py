#!/usr/bin/env python3
"""One pass over the registration engine's main path on one NVIDIA GPU.

    python chip_smoke.py                  # phases 0-6 on one GPU
    python chip_smoke.py --four-cards     # phase 7 only: 4-GPU mesh vs 1 GPU
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse   # tiny CPU rehearsal

Phases (each passes or the script exits non-zero; the last stdout line,
printed only when every phase passed, is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}):

  0  device: require a GPU; print device_kind, count, the card's name and
     power limit (nvidia-smi), and the compile-cache directory
  1  exact EDT at 20^3 (BO1 cavity) and 300^3 (demo scale) vs brute force
  2  bound evaluation at BO1 widths vs the float64 reference
  3  scoring and ICP vs the float64 reference (catches reduced precision)
  4  the BO1 sweep through the CLI (`run-bo1 --engine fused`) and one
     `run-pair --engine device`, checked against each pair's ground truth
  5  the bench's two pools through the fused stream at the bench shape
  6  the demo-scale registration through the CLI (`run-demo`)
  7  (--four-cards) pair-DP fused stream and rotation-lane sharding over
     four GPUs against the same calls on one GPU

Inputs are generated from --seed; nothing is read from outside the repo.
Outputs go under --out-dir (default .smoke_out/ in the repo).
--rehearse shrinks every size so the whole path runs on the CPU; it skips
only the GPU requirement, and its last line reports the real platform.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

# every tolerance of this script, in one place
TOL = {
    # EDT distances, world units (tests/test_grid.py); nearest-cell ties
    # must resolve to a cell at the same distance
    "edt_abs": 1e-4,
    # float32 bound / score sums vs float64, relative (with a 1e-6
    # absolute floor for sums that are ~0)
    "sum_rel": 1e-5,
    "sum_abs": 1e-6,
    # ICP: R entries and t, absolute (normalized units); the error sum
    # relative to the magnitude its d^2 = |p|^2 - 2 p.m + |m|^2 cancels
    "icp_abs": 1e-5,
    "icp_err_rel": 1e-5,
    # share of bound nodes / corners a voxel-rounding tie may exclude
    "max_ambiguous_share": 0.10,
    # ground-truth RMSD of a registered pair, in the inputs' units (cavity
    # clouds span ~1.5, the demo cloud ~1.8), set after the CPU rehearsal,
    # where both land at ~1e-6 (data clouds are exact subsets); the demo's
    # epsilon bounds DT error, not the distance to the truth, and ICP's
    # stop rule can end early on a smooth surface, hence its wider bound
    "rmsd_bo1": 1e-3,
    "rmsd_demo": 1e-2,
}

SIZES = {
    # name: (full, rehearse)
    "edt_big": (300, 40),
    "edt_big_points": (35947, 3000),
    "edt_samples": (100_000, 5_000),
    "bo1_pairs": (16, 2),
    "pool_similar": (64, 4),
    "pool_trimmed": (32, 4),
    "demo_model": (35947, 3000),
    "demo_data": (1000, 150),
    "demo_size": (300, 40),
    "four_pool": (64, 8),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


class Smoke:
    def __init__(self, args):
        self.args = args
        self.rehearse = args.rehearse
        self.seed = args.seed
        self.out = os.path.abspath(args.out_dir)
        os.makedirs(self.out, exist_ok=True)

    def size(self, name):
        return SIZES[name][1 if self.rehearse else 0]

    def peak(self, label):
        from goicp_tpu.utils.device import peak_bytes
        import jax
        say(f"[{label}] peak_bytes_in_use="
            + ", ".join(f"{d.id}:{peak_bytes(d)}" for d in jax.devices()))

    # ---------------------------------------------------------------- 0
    def phase0(self):
        import jax

        from goicp_tpu.utils.device import (card_name_and_power_limit,
                                            device_summary)
        dev = device_summary()
        say(f"[0] JAX devices: platform={dev['platform']} "
            f"kind={dev['kind']} count={dev['count']}")
        if dev["platform"] != "gpu" and not self.rehearse:
            raise SystemExit(f"FAILED: no GPU: JAX runs on "
                             f"{dev['platform']}")
        self.card = card_name_and_power_limit()
        say("[0] card name, power limit (nvidia-smi):")
        say(self.card)
        say(f"[0] compile cache: "
            f"{jax.config.jax_compilation_cache_dir or 'off'}")
        self.device = dev
        return dev

    # ---------------------------------------------------------------- 1
    def phase1(self):
        import jax

        from goicp_tpu.bench.measure import demo_scale_clouds
        from goicp_tpu.grid.edt import (_edt_fields, _occupied_cells,
                                        build_grid, grid_geometry)
        rng = np.random.default_rng(self.seed)

        small = rng.uniform(-0.75, 0.75, size=(306, 3))
        props = rng.integers(0, 9, 306).astype(np.int32)
        t0 = time.time()
        g = build_grid(small, props, 20, 2.0)
        jax.block_until_ready(g.dist)
        t_small = time.time() - t0
        self._check_edt(g, np.arange(20 ** 3), "20^3")

        size = self.size("edt_big")
        model, _, _ = demo_scale_clouds(self.seed,
                                        self.size("edt_big_points"), 10)
        zeros = np.zeros(len(model), np.int32)
        # compile the big EDT program, drop every in-memory cache, compile
        # it again: the second compile reads the persistent cache
        geom = grid_geometry(model, size, 2.0)
        cells = _occupied_cells(model, zeros, geom)
        n_pad = cells["cell_coords"].shape[0]
        coords = np.full((max(4096, -(-n_pad // 4096) * 4096), 3), 2 ** 20,
                         np.int32)
        coords[:n_pad] = cells["cell_coords"]
        compile_s = []
        for _ in range(2):
            jax.clear_caches()
            lowered = _edt_fields.lower(jax.numpy.asarray(coords), size=size)
            t0 = time.time()
            lowered.compile()
            compile_s.append(time.time() - t0)
        say(f"[1] compile seconds, EDT {size}^3 program: first "
            f"{compile_s[0]:.3f} s; re-run after jax.clear_caches(): "
            f"{compile_s[1]:.3f} s (cache dir "
            f"{jax.config.jax_compilation_cache_dir or 'off'})")

        t0 = time.time()
        gb = build_grid(model, zeros, size, 2.0)
        jax.block_until_ready(gb.dist)
        t_big = time.time() - t0
        sample = rng.choice(size ** 3, self.size("edt_samples"),
                            replace=False)
        self._check_edt(gb, sample, f"{size}^3")
        say(f"[1] EDT walls: 20^3 {t_small:.3f} s (first call, compile "
            f"included), {size}^3 {t_big:.3f} s ({gb.n_cells} occupied "
            f"cells)")

    def _check_edt(self, g, flat_ids, label):
        """g's distance field at flat voxel ids vs brute force (float64)."""
        s = g.geom.size
        occ = np.asarray(g.cell_coords)[:g.n_cells].astype(np.float64)
        vox = np.stack([flat_ids % s, (flat_ids // s) % s,
                        flat_ids // (s * s)], axis=1).astype(np.float64)
        occ_n = np.sum(occ * occ, axis=1)
        best = np.empty(len(vox))
        for lo in range(0, len(vox), 2048):
            v = vox[lo:lo + 2048]
            d2 = np.sum(v * v, axis=1)[:, None] - 2.0 * v @ occ.T \
                + occ_n[None, :]
            best[lo:lo + 2048] = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
        brute = best / g.geom.scale
        dist = np.asarray(g.dist)[flat_ids]
        chosen = np.asarray(g.nearest_cell)[flat_ids]
        d_chosen = np.linalg.norm(vox - occ[chosen], axis=1) / g.geom.scale
        e1 = float(np.max(np.abs(dist - brute)))
        e2 = float(np.max(np.abs(d_chosen - brute)))
        say(f"[1] EDT {label}: {len(flat_ids)} voxels vs brute force "
            f"(float64): max |dist - brute| = {e1:.3g}, max |d(nearest "
            f"cell) - brute| = {e2:.3g} (tolerance {TOL['edt_abs']}, "
            f"float32 field, HIGHEST-precision matmul)")
        check(e1 <= TOL["edt_abs"] and e2 <= TOL["edt_abs"],
              f"EDT {label} differs from brute force")

    # ---------------------------------------------------------------- 2/3
    def _bo1_pair(self, trim_fraction=0.0, norm=2, dynamic=False, **kw):
        from goicp_tpu.bench.measure import normalized_synthetic, \
            synthetic_pool
        from goicp_tpu.config import GoICPConfig
        from goicp_tpu.pipeline.prepare import make_count_dynamic, \
            prepare_pair
        entry = synthetic_pool(1, seed=self.seed, with_truth=True)[0]
        data, model, dp, mp = normalized_synthetic(entry[:5])
        cfg = GoICPConfig(trimFraction=trim_fraction, norm=norm, **kw)
        pair = prepare_pair(data, model, dp, mp, cfg, bucket=True)
        return (make_count_dynamic(pair) if dynamic else pair), cfg

    def phase2(self):
        import jax
        import jax.numpy as jnp

        from goicp_tpu.bounds import evaluate as ev
        from goicp_tpu.bounds import reference as ref
        from goicp_tpu.geom.rotation import rodrigues
        rng = np.random.default_rng(self.seed + 2)
        L = 8
        worst = 0.0
        n_cmp = 0
        for B in (128, 256):
            for norm in (1, 2):
                for trim in ("off", "static", "dynamic"):
                    pair, cfg = self._bo1_pair(
                        trim_fraction=0.0 if trim == "off" else 0.1,
                        norm=norm, dynamic=trim == "dynamic")
                    check(ev._trim_mode(pair, cfg) == trim, "trim mode")
                    R = rodrigues(jnp.asarray(
                        rng.uniform(-2, 2, (L, 3)), jnp.float32))
                    pts = jnp.einsum("lij,nj->lni", R, pair.data,
                                     precision=jax.lax.Precision.HIGHEST)
                    centers = jnp.asarray(rng.uniform(-0.45, 0.45,
                                                      (L, B, 3)), jnp.float32)
                    widths = jnp.asarray(
                        2.0 ** -rng.integers(1, 6, (L, B)), jnp.float32)
                    mrd = ev.rot_uncertainty(
                        jnp.asarray(2.0 ** -rng.integers(1, 6, L),
                                    jnp.float32), pair.norm_data)
                    for fused in (False, True):
                        fn = ev.geometric_bounds_fused if fused \
                            else ev.geometric_bounds
                        dev = jax.jit(fn, static_argnums=1)(
                            pair, cfg, pts, centers, widths, mrd)
                        want, ok = ref.geometric_bounds(
                            pair, cfg, pts, centers, widths, mrd,
                            fused=fused)
                        rel = self._cmp(dev, want, ok,
                                        f"B={B} norm={norm} trim={trim} "
                                        f"fused={fused}")
                        worst = max(worst, rel)
                        n_cmp += 1
        say(f"[2] geometric bounds: {n_cmp} configurations (L={L}, "
            f"B in 128/256, Nd={pair.n_data_padded} padded, norm 1/2, trim "
            f"off/static/dynamic, plain and fused): worst error "
            f"{worst:.3g} of the tolerance (relative {TOL['sum_rel']} + "
            f"absolute {TOL['sum_abs']}; float32 sums vs float64)")

        # chem corner values with all three terms (incomp, FPFH, neighbour)
        pair, cfg = self._bo1_pair(regularization=0.0005, cfpfh=1,
                                   regularizationFPFH=0.01,
                                   regularizationNeighbors=0.001)
        pair = self._with_fpfh(pair, cfg, rng)
        R = rodrigues(jnp.asarray(rng.uniform(-2, 2, (L, 3)), jnp.float32))
        pts = jnp.einsum("lij,nj->lni", R, pair.data,
                         precision=jax.lax.Precision.HIGHEST)
        corners = jnp.asarray(rng.uniform(-0.5, 0.5, (L, 27 * 8, 3)),
                              jnp.float32)
        dev = jax.jit(ev.chem_corner_values, static_argnums=1)(
            pair, cfg, pts, corners)
        want, ok = ref.chem_corner_values(pair, cfg, pts, corners)
        check(set(dev) == set(want) == {"incomp", "fpfh", "nbr"},
              "chem terms")
        for k in ("incomp", "nbr"):
            d = np.asarray(dev[k])
            check(np.array_equal(d[ok], want[k][ok]), f"chem {k} counts")
        rel = self._cmp((dev["fpfh"],), (want["fpfh"],), ok, "chem fpfh")
        say(f"[2] chem corner values: L={L}, Q={corners.shape[1]}: incomp "
            f"and neighbour counts exact, FPFH mean worst error {rel:.3g} "
            f"of the tolerance; {int(ok.sum())}/{ok.size} corners free of "
            f"voxel-rounding ties")

    def _with_fpfh(self, pair, cfg, rng):
        """Re-prepare the pair with seeded 41-bin descriptors."""
        from goicp_tpu.bench.measure import normalized_synthetic, \
            synthetic_pool
        from goicp_tpu.pipeline.prepare import prepare_pair
        entry = synthetic_pool(1, seed=self.seed, with_truth=True)[0]
        data, model, dp, mp = normalized_synthetic(entry[:5])
        return prepare_pair(data, model, dp, mp, cfg,
                            rng.uniform(0, 50, (len(data), 41)),
                            rng.uniform(0, 50, (len(model), 41)),
                            bucket=True)

    def _cmp(self, dev, want, ok, label):
        """Device sums vs reference over unambiguous entries.  Returns the
        largest |dev - ref| / (sum_rel |ref| + sum_abs): the share of the
        tolerance used, which must not exceed 1."""
        share = 1.0 - float(np.mean(ok))
        check(share <= TOL["max_ambiguous_share"],
              f"{label}: {share:.1%} of entries on voxel-rounding ties")
        worst = 0.0
        for d, w in zip(dev, want):
            d = np.asarray(d, np.float64)[ok]
            w = np.asarray(w, np.float64)[ok]
            used = np.abs(d - w) / (TOL["sum_rel"] * np.abs(w)
                                    + TOL["sum_abs"])
            worst = max(worst, float(np.max(used, initial=0.0)))
        check(worst <= 1.0, f"{label}: {worst:.3g} of the tolerance")
        return worst

    def phase3(self):
        import jax
        import jax.numpy as jnp

        from goicp_tpu.bounds import reference as ref
        from goicp_tpu.bounds.error import score_transform
        from goicp_tpu.geom.normalize import normalize_pair
        from goicp_tpu.geom.rotation import rodrigues_np
        from goicp_tpu.icp.icp import icp_run
        from goicp_tpu.bench.measure import synthetic_pool

        # ground truth of pool pair 0 in the normalized frame
        _, data_raw, model_raw, _, _, truth_raw = synthetic_pool(
            1, seed=self.seed, with_truth=True)[0]
        norm = normalize_pair(data_raw, model_raw)
        src = (data_raw - norm["source_mean"]) / norm["scale"]
        tgt = (truth_raw - norm["target_mean"]) / norm["scale"]
        R_true = ref.kabsch(src - src.mean(0), tgt - tgt.mean(0))
        t_true = tgt.mean(0) - R_true @ src.mean(0)
        R0 = R_true @ rodrigues_np(np.array([0.12, -0.08, 0.05]))
        t0 = t_true + 0.02
        for trim in (0.0, 0.1):
            pair, cfg = self._bo1_pair(trim_fraction=trim)
            dev = jax.device_get(icp_run(
                pair.data, pair.model, jnp.asarray(R0, jnp.float32),
                jnp.asarray(t0, jnp.float32), inlier_num=pair.inlier_num,
                max_iter=cfg.icp_max_iter, err_diff=cfg.err_diff,
                data_mask=pair.data_mask))
            want = ref.icp_run(pair.data, pair.model, R0, t0,
                               pair.inlier_num, cfg.icp_max_iter,
                               cfg.err_diff, pair.data_mask)
            eR = float(np.max(np.abs(np.asarray(dev.R) - want["R"])))
            et = float(np.max(np.abs(np.asarray(dev.t) - want["t"])))
            ee = abs(float(dev.err) - want["err"]) / want["scale"]
            say(f"[3] ICP trim={trim}: iterations {int(dev.iters)} vs "
                f"{want['iters']} (float64); max |dR| {eR:.3g}, max |dt| "
                f"{et:.3g} (tolerance {TOL['icp_abs']}); |d err| / "
                f"sum(|p|^2+|m|^2) {ee:.3g} (tolerance "
                f"{TOL['icp_err_rel']})")
            check(eR <= TOL["icp_abs"] and et <= TOL["icp_abs"]
                  and ee <= TOL["icp_err_rel"], f"ICP trim={trim}")

            # score at the ICP start and at its result, each nudged off any
            # voxel-rounding tie
            for label, R_sc, t_base in (("start", R0, t0),
                                        ("ICP result", dev.R, dev.t)):
                R_sc = np.asarray(R_sc, np.float32)
                for k in range(8):
                    t_sc = np.asarray(t_base, np.float32) \
                        + np.float32(1e-4) * k
                    want_sc, ok = ref.score_transform(pair, cfg, R_sc, t_sc,
                                                      dev.nn_idx)
                    if ok:
                        break
                check(ok, "score lookups on voxel-rounding ties")
                sc = jax.device_get(score_transform(
                    pair, cfg, jnp.asarray(R_sc), jnp.asarray(t_sc),
                    dev.nn_idx))
                rel = self._cmp((sc.error, sc.geom),
                                (want_sc["error"], want_sc["geom"]),
                                np.asarray(True), f"score trim={trim}")
                say(f"[3] score_transform trim={trim} at the {label}: "
                    f"error {float(sc.error):.6g}, worst error {rel:.3g} of "
                    f"the tolerance (relative {TOL['sum_rel']} + absolute "
                    f"{TOL['sum_abs']})")

    # ---------------------------------------------------------------- 4
    def phase4(self):
        from goicp_tpu import cli
        from goicp_tpu.bench.measure import synthetic_pool
        from goicp_tpu.config import GoICPConfig
        from goicp_tpu.io.mol2 import write_mol2
        from goicp_tpu.io.output import read_output
        from goicp_tpu.io.tsv import write_pair_list

        n = self.size("bo1_pairs")
        tree = os.path.join(self.out, "bo1")
        os.makedirs(os.path.join(tree, "cavities"), exist_ok=True)
        pool = synthetic_pool(n, seed=self.seed, with_truth=True)
        names = []
        for name, data, model, dp, mp, _ in pool:
            write_mol2(os.path.join(tree, "cavities",
                                    f"{name}d_cavity6.mol2"), data, dp)
            write_mol2(os.path.join(tree, "cavities",
                                    f"{name}m_cavity6.mol2"), model, mp)
            names.append((f"{name}d", f"{name}m"))
        write_pair_list(os.path.join(tree,
                                     "cavities_similar_BO1_clean.tsv"), names)
        config = os.path.join(tree, "config.txt")
        GoICPConfig().to_file(config)
        out = os.path.join(self.out, "bo1_out")
        if os.path.isdir(out):
            import shutil
            shutil.rmtree(out)

        t0 = time.time()
        check(cli.main(["run-bo1", tree, config, "--engine", "fused",
                        "--no-rmsd", "--out-dir", out, "-q"]) == 0, "run-bo1")
        wall = time.time() - t0
        with open(os.path.join(out, "results_similar.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh if ln.strip()]
        bad = [r for r in rows if r.get("failed") or r.get("skipped")]
        check(not bad, f"failed/skipped sweep rows: {bad}")
        check(sorted(r["pair"] for r in rows) == list(range(1, n + 1)),
              "one row per pair")
        eps = GoICPConfig().MSEThresh
        worst = 0.0
        for r in rows:
            k = r["pair"]
            check(r["converged"], f"pair {k} not converged")
            _, data, _, _, _, truth = pool[k - 1]
            resc = read_output(os.path.join(out, "output",
                                            f"similar{k}_rescaled.txt"))
            rmsd = _rmsd(data @ resc["R"].T + resc["t"], truth)
            worst = max(worst, rmsd)
            check(rmsd <= TOL["rmsd_bo1"],
                  f"pair {k}: ground-truth RMSD {rmsd:.3g}")
            check(r["error"] <= eps * len(data),
                  f"pair {k}: error {r['error']} above epsilon")
        say(f"[4] run-bo1 --engine fused: {n} pairs in {wall:.3f} s "
            f"(compile included), all converged, worst ground-truth RMSD "
            f"{worst:.3g} (tolerance {TOL['rmsd_bo1']})")

        name, data, model, _, _, truth = pool[0]
        out_txt = os.path.join(out, "pair1_device.txt")
        t0 = time.time()
        check(cli.main(["run-pair",
                        os.path.join(tree, "cavities",
                                     f"{name}m_cavity6.mol2"),
                        os.path.join(tree, "cavities",
                                     f"{name}d_cavity6.mol2"),
                        str(len(data)), config, out_txt, "1", "--out-dir",
                        out, "--engine", "device", "-q"]) == 0, "run-pair")
        wall = time.time() - t0
        res = read_output(out_txt)
        resc = read_output(out_txt.rsplit(".", 1)[0] + "_rescaled.txt")
        rmsd = _rmsd(data @ resc["R"].T + resc["t"], truth)
        check(res["error"] <= eps * len(data), "run-pair error above eps")
        check(rmsd <= TOL["rmsd_bo1"], f"run-pair RMSD {rmsd:.3g}")
        say(f"[4] run-pair --engine device on pair 1: error "
            f"{res['error']:.6g} (epsilon {eps * len(data):.3g}), "
            f"ground-truth RMSD {rmsd:.3g}, {wall:.3f} s")

    # ---------------------------------------------------------------- 5
    def phase5(self):
        import jax

        from goicp_tpu.bench import measure as m
        from goicp_tpu.config import GoICPConfig

        cfg = m.bench_shape(GoICPConfig())
        cfg_t = dataclasses.replace(cfg, trimFraction=m.TRIM_FRACTION,
                                    trans_capacity=m.TRIM_CAPACITY)
        n_s, n_t = self.size("pool_similar"), self.size("pool_trimmed")
        pools = [
            ("similar", cfg, [m.normalized_synthetic(e)
                              for e in m.synthetic_pool(n_s)],
             m.SIMILAR_BUCKETS),
            ("trimmed", cfg_t, [m.normalized_synthetic(e)
                                for e in m.synthetic_pool_trimmed(n_t)],
             m.TRIM_BUCKETS),
        ]
        for name, c, raw, nb in pools:
            buckets = m.bucket_and_prepare_multi(raw, c, nb)
            ordered = m.in_pool_order(buckets, len(raw))
            walls = []
            for _ in range(2):                      # cold (compile), warm
                t0 = time.time()
                out = m.reassemble(m.run_pool(buckets, c), len(raw))
                walls.append(time.time() - t0)
                m.check_converged_with_margin(out, c, ordered)
            evals = int(np.sum(np.asarray(out.evals)))
            say(f"[5] {name} pool: {len(raw)} pairs in {len(buckets)} "
                f"buckets (cap {c.trans_capacity}, width {m.FUSED_WIDTH}, "
                f"chunk {m.FUSED_CHUNK}): all converged, margin guard "
                f"held; cold wall (compile included) {walls[0]:.3f} s, "
                f"compile ~{walls[0] - walls[1]:.3f} s, warm wall "
                f"{walls[1]:.3f} s ({len(raw) / walls[1]:.4f} pairs/s, "
                f"{evals / walls[1]:.1f} bound evals/s) on {self.card}")
            if name == "similar" and self.args.trace:
                self._trace(buckets, out, c)
            self.peak(f"5 {name}")

    def _trace(self, buckets, out, cfg, chunks: int = 3):
        """Trace `chunks` warm dispatches of the fused stream's chunk
        program on a window of the two highest-eval pairs of one bucket
        (a steady window: both are in flight throughout); reduce it."""
        import jax

        from goicp_tpu.bench import measure as m
        from goicp_tpu.bounds.evaluate import BOUND_SCOPE
        from goicp_tpu.dist.mesh import stack_pairs
        from goicp_tpu.search import fused_stream as fs
        from goicp_tpu.utils import profiling

        evals = np.asarray(out.evals)
        bp, idxs = max(buckets, key=lambda b: evals[b[1]].max())
        top = np.argsort(-evals[idxs])[:m.FUSED_WIDTH]
        pb = stack_pairs([bp[j] for j in top])
        steps = np.int32(m.FUSED_CHUNK)
        state = fs._jit_init(cfg)(pb)
        state = fs.fused_run_chunk(pb, cfg, state, steps)      # warm
        jax.block_until_ready(state)
        hlo = fs.fused_run_chunk.lower(pb, cfg, state,
                                       steps).compile().as_text()
        scope_ops = profiling.hlo_ops_in_scope(hlo, BOUND_SCOPE)
        log_dir = self.args.trace
        with jax.profiler.trace(log_dir):
            with jax.profiler.TraceAnnotation("smoke_window"):
                t0 = time.time()
                for _ in range(chunks):
                    state = fs.fused_run_chunk(pb, cfg, state, steps)
                    np.asarray(state["converged"])  # the stream loop's sync
                wall = time.time() - t0
        conv = np.asarray(state["converged"])
        # XLA:CPU (a rehearsal) runs its ops on host threads
        plane = "/device:" if self.device["platform"] == "gpu" \
            else "/host:CPU"
        s = profiling.summarize_trace(log_dir, plane_prefix=plane,
                                      window="smoke_window",
                                      scope=BOUND_SCOPE, scope_ops=scope_ops)
        s.update(wall_s=wall, chunks=chunks, chunk_steps=int(steps),
                 pair_evals=evals[np.asarray(idxs)[top]].tolist(),
                 converged_after=conv.tolist(), card=self.card,
                 n_scope_hlo_ops=len(scope_ops))
        with open(os.path.join(log_dir, "trace_summary.json"), "w") as fh:
            json.dump(s, fh, indent=1)
        say(f"[5] trace: {chunks} chunks x {int(steps)} global iterations "
            f"of the fused stream on a width-{len(top)} window (pairs with "
            f"{s['pair_evals']} evals; converged after: {conv.tolist()}): "
            f"wall {wall:.3f} s; window {s['window_ns']:.0f} ns, busy "
            f"{s['busy_ns']:.0f} ns, idle share {s['idle_share']:.4f}; "
            f"bound evaluation {s['scope_ns']:.0f} ns = "
            f"{s['scope_share_of_window']:.4f} of the window, "
            f"{s['scope_share_of_busy']:.4f} of busy ({len(scope_ops)} HLO "
            f"ops in scope, {s['n_events']} device events)")
        for name, ns in s["top_ops"]:
            say(f"[5]   top device op {name}: {ns:.0f} ns")
        for ln in s["lines"]:
            say(f"[5]   trace line {ln['plane']} / {ln['line']}: "
                f"{ln.get('events', 0)} events")

    # ---------------------------------------------------------------- 6
    def phase6(self):
        from goicp_tpu import cli
        from goicp_tpu.bench.measure import demo_scale_clouds
        from goicp_tpu.io.output import read_output
        from goicp_tpu.io.xyz import write_normalized_cloud
        from goicp_tpu.pipeline.demo import DEMO_CONFIG

        nm, nd = self.size("demo_model"), self.size("demo_data")
        model, data, truth = demo_scale_clouds(self.seed + 6, nm, nd)
        d = os.path.join(self.out, "demo")
        os.makedirs(d, exist_ok=True)
        mfile, dfile = os.path.join(d, "model.xyz"), os.path.join(d,
                                                                  "data.xyz")
        write_normalized_cloud(mfile, model)
        write_normalized_cloud(dfile, data)
        base = dataclasses.replace(DEMO_CONFIG,
                                   distTransSize=self.size("demo_size"))
        for seeds in (1, 4):
            cfg = dataclasses.replace(base, icp_seeds=seeds)
            argv = ["run-demo", mfile, dfile, str(nd), "-q",
                    "--output", os.path.join(d, f"out_seeds{seeds}.txt")]
            if cfg != DEMO_CONFIG:
                cfg_path = os.path.join(d, f"config_seeds{seeds}.txt")
                cfg.to_file(cfg_path)
                argv += ["--config", cfg_path]
            t0 = time.time()
            check(cli.main(argv) == 0, "run-demo")
            wall = time.time() - t0
            res = read_output(os.path.join(d, f"out_seeds{seeds}.txt"))
            data_q = np.loadtxt(dfile, skiprows=1)
            rmsd = _rmsd(data_q @ res["R"].T + res["t"], truth)
            eps = cfg.MSEThresh * nd
            say(f"[6] run-demo icp_seeds={seeds}: {nm}-point model, "
                f"{nd}-point data, {cfg.distTransSize}^3 DT: error "
                f"{res['error']:.6g} (epsilon {eps:.3g}), ground-truth RMSD "
                f"{rmsd:.3g} (tolerance {TOL['rmsd_demo']}), registration "
                f"{res['time']:.3f} s, command {wall:.3f} s "
                f"(grid build and compile included)")
            check(res["error"] <= eps, f"demo icp_seeds={seeds} error")
            check(rmsd <= TOL["rmsd_demo"], f"demo icp_seeds={seeds} RMSD")
            self.peak(f"6 icp_seeds={seeds}")

    # ---------------------------------------------------------------- 7
    def phase7(self):
        import jax

        from goicp_tpu.bench import measure as m
        from goicp_tpu.config import GoICPConfig
        from goicp_tpu.dist.mesh import make_mesh, stack_pairs
        from goicp_tpu.search.device_engine import register_device
        from goicp_tpu.search.fused_stream import register_fused_stream
        from goicp_tpu.search.sharded_engine import register_device_sharded
        from jax.sharding import NamedSharding, PartitionSpec as P

        devs = jax.devices()
        check(len(devs) >= 4, f"--four-cards needs 4 devices, found "
              f"{len(devs)}")
        cfg = m.bench_shape(GoICPConfig())
        n = self.size("four_pool")
        raw = [m.normalized_synthetic(e) for e in m.synthetic_pool(n)]
        # one shape bucket: each bucket compiles its own programs per
        # variant, and compiling, not running, dominates this phase
        buckets = m.bucket_and_prepare_multi(raw, cfg, 1)
        mesh_dp = make_mesh(n_data=4, n_search=1, devices=devs[:4])

        def run(mesh):
            with jax.default_device(devs[0]):
                return m.reassemble(
                    [(idxs, register_fused_stream(
                        bp, cfg, width=4, chunk_steps=m.FUSED_CHUNK,
                        mesh=mesh)) for bp, idxs in buckets], n)

        walls = {}
        outs = {}
        for label, mesh in (("4 cards", mesh_dp), ("1 card", None)):
            walls[label] = []
            for _ in range(2):                          # cold, warm
                t0 = time.time()
                outs[label] = run(mesh)
                walls[label].append(time.time() - t0)
        a, b = outs["4 cards"], outs["1 card"]
        check(np.array_equal(np.asarray(a.error), np.asarray(b.error)),
              "pair-DP errors differ from one card")
        check(np.array_equal(np.asarray(a.evals), np.asarray(b.evals)),
              "pair-DP eval counts differ from one card")
        check(bool(np.all(np.asarray(a.converged))), "pair-DP convergence")
        say(f"[7] fused stream, {n} similar pairs (one bucket), width 4: "
            f"per-pair "
            f"error and eval counts identical on 4 cards (mesh data=4) and "
            f"1 card; walls cold/warm: 4 cards {walls['4 cards'][0]:.3f}/"
            f"{walls['4 cards'][1]:.3f} s, 1 card {walls['1 card'][0]:.3f}"
            f"/{walls['1 card'][1]:.3f} s on {self.card}")
        placed = jax.device_put(stack_pairs(buckets[0][0][:4]),
                                NamedSharding(mesh_dp, P("data")))
        say(f"[7] pair-axis placement: "
            f"{sorted(d.id for d in placed.data.sharding.device_set)}")

        # rotation-lane sharding of the pool's highest-eval pair
        hi = int(np.argmax(np.asarray(b.evals)))
        pair = m.in_pool_order(buckets, n)[hi]
        mesh_s = make_mesh(n_data=1, n_search=4, devices=devs[:4])
        t0 = time.time()
        rs = jax.device_get(register_device_sharded(pair, cfg, mesh_s))
        w4 = time.time() - t0
        with jax.default_device(devs[0]):
            t0 = time.time()
            r1 = jax.device_get(register_device(pair, cfg))
            w1 = time.time() - t0
        eps = cfg.MSEThresh * float(np.asarray(pair.counts)[1])
        check(bool(rs.converged) and bool(r1.converged),
              "sharded/single convergence")
        check(abs(float(rs.error) - float(r1.error)) <= eps,
              "sharded error outside epsilon of one card")
        say(f"[7] register_device_sharded (mesh search=4) on pool pair "
            f"{hi} ({int(np.asarray(b.evals)[hi])} evals on one card): "
            f"error {float(rs.error):.6g} vs {float(r1.error):.6g} on one "
            f"card (epsilon {eps:.3g}); walls (compile included) 4 cards "
            f"{w4:.3f} s, 1 card {w1:.3f} s")
        for d in devs[:4]:
            say(f"[7] card {d.id} memory_stats: {d.memory_stats()}")


def _rmsd(a, b) -> float:
    return float(np.sqrt(np.mean(np.sum((np.asarray(a) - b) ** 2,
                                        axis=1))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.join(HERE, ".smoke_out"))
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes, any platform (a CPU rehearsal)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 7 on four GPUs")
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of phases 1-6 "
                         "(phase 0 always runs)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="phase 5 also traces one similar bucket into DIR, "
                         "and reduces it to DIR/trace_summary.json")
    args = ap.parse_args(argv)

    smoke = Smoke(args)
    dev = smoke.phase0()
    if args.four_cards:
        phases = [7]
    elif args.phases:
        phases = [int(p) for p in args.phases.split(",")]
    else:
        phases = [1, 2, 3, 4, 5, 6]
    for p in phases:
        t0 = time.time()
        getattr(smoke, f"phase{p}")()
        say(f"[{p}] phase {p} passed in {time.time() - t0:.3f} s")
        smoke.peak(str(p))
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
