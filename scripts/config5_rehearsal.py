"""North-star config-5 dress rehearsal: 3M splats @ 4K over a sharded mesh.

Real multi-host hardware is not available in this environment, so this
validates the >8-host design on the virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8) at the TARGET SHAPES:

  1. Full-shape sharded binning (3M splats, 3840×2160, sparse all_to_all
     exchange): per-band pair accounting — every (gaussian, tile) pair lands
     in exactly one band, so the per-band counts must sum to the single-chip
     total — plus capacity/overflow telemetry and per-stage wall-clock.
  2. End-to-end sharded image correctness (exchange + binning + raster +
     autodiff path) at a memory-feasible resolution (the pure-jnp band raster
     materializes pairs×pixels, which only the Pallas kernels can do at 4K).

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/config5_rehearsal.py [--n 3000000] [--probe-res 960 540]
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__" and "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# the rehearsal is a virtual-mesh run by design: pin the CPU even where a GPU
# is visible (make_mesh also asserts the requested device count)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3_000_000)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--probe-res", type=int, nargs=2, default=(960, 540))
    ap.add_argument("--ndev", type=int, default=8)
    args = ap.parse_args(argv)

    import dataclasses

    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.ops.binning import bin_gaussians, tile_rects
    from gaussian_splat_tpu.ops.render import _project_and_shade, render
    from gaussian_splat_tpu.parallel.mesh import make_mesh, shard_model
    from gaussian_splat_tpu.parallel.sharded_render import (
        render_sharded,
        sharded_binning_stats,
    )

    ndev = args.ndev
    mesh = make_mesh(ndev)
    n = -(-args.n // ndev) * ndev

    model = gs.GaussianModel.random(
        jax.random.PRNGKey(0), n, sh_degree=1, extent=2.0, scale_range=(0.004, 0.02)
    )
    model = shard_model(model, mesh)
    camera = gs.Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
        60.0, args.width, args.height,
    )

    # --- 0. calibration: size capacities from the scene, not from hope -------
    # The round-4 run used the default fraction capacity (n/32+1 = 94k) at a
    # shape with ~402k big-tier-ELIGIBLE splats — the tier overflowed 308k
    # deep, forcing population-relative shrinks (413k clamped rects, 2.5M
    # mis-partitioned pairs). Exactness is a CAPACITY property: measure the
    # eligible count on a calibration frame, set big_tier_capacity above it,
    # and the partition is exact by construction (tier_overflow sentinel 0).
    cal_cfg = gs.RenderConfig(backend="jnp_tile")
    proj_cal, _ = _project_and_shade(model, camera, cal_cfg)
    _tx0, _ty0, w_c, h_c, _cl = jax.jit(
        lambda p: tile_rects(
            p.means2d, p.radii, p.valid, args.width, args.height, cal_cfg,
            extents=p.extents,
        )
    )(proj_cal)
    area_cal = np.asarray(w_c) * np.asarray(h_c)
    eligible = int((area_cal > cal_cfg.small_tiles_per_gaussian).sum())
    sum_area = int(area_cal.sum())
    big_cap = -(-int(eligible * 1.2) // 1024) * 1024  # 20% headroom
    # pairs_per_gaussian from the measured pre-σ pair total (+~40% headroom:
    # the σ test only removes pairs); shard_capacity_margin from the measured
    # band incidence at this shape (max band holds N/8 + 0.078*N) — 0.15
    # keeps ~2x headroom on the tail term.
    ppg = max(4.0, round(sum_area / n * 1.4, 1))
    cfg = dataclasses.replace(
        gs.RenderConfig(backend="jnp_tile", shard_exchange="all_to_all"),
        big_tier_capacity=big_cap,
        pairs_per_gaussian=ppg,
        shard_capacity_margin=0.15,
    )
    del proj_cal, w_c, h_c

    report = {
        "n": n,
        "resolution": [args.width, args.height],
        "ndev": ndev,
        "calibration": {
            "big_eligible": eligible,
            "big_tier_capacity": big_cap,
            "sum_rect_area": sum_area,
            "pairs_per_gaussian": ppg,
            "shard_capacity_margin": 0.15,
        },
    }

    # --- 1. full-shape sharded binning + accounting --------------------------
    t0 = time.perf_counter()
    stats = jax.jit(
        lambda m: sharded_binning_stats(m, camera, cfg, mesh)
    )(model)
    jax.block_until_ready(stats)
    t1 = time.perf_counter()
    band_pairs = np.asarray(jax.device_get(stats.num_pairs))

    # single-chip ground truth for the pair totals (opacities → the σ-bound
    # tile test runs, matching the sharded render path)
    from gaussian_splat_tpu.ops.render import _effective_opacities

    # the sharded frame pads the height so every band owns an equal integer
    # number of tile rows (135 -> 136 at 2160/8); splats extending past the
    # true bottom edge legitimately emit pairs in the padded row, so the
    # single-chip reference must bin the SAME padded frame for the
    # accounting to be exact (+15k pairs at this shape otherwise). The whole
    # reference path runs under ONE jit: eager-mode projection drifts from
    # the jitted band pipeline by 1 ulp on a handful of splats (LLVM FMA
    # contraction differs per compilation context), which flipped ~20 rect/
    # sigma boundary cells out of 14M before this was jitted.
    ty_n = cfg.tiles_y(args.height)
    padded_h = -(-ty_n // ndev) * ndev * cfg.tile_height

    @jax.jit
    def single_ref(m):
        proj, _ = _project_and_shade(m, camera, cfg)
        opac = _effective_opacities(m, proj, cfg)
        return bin_gaussians(proj, args.width, padded_h, cfg, opacities=opac)

    single = single_ref(model)
    total = int(single.num_pairs)
    t2 = time.perf_counter()

    report["sharded_bin_wall_s"] = round(t1 - t0, 2)
    report["single_chip_bin_wall_s"] = round(t2 - t1, 2)
    report["per_band_pairs"] = band_pairs.tolist()
    report["per_band_overflow"] = np.asarray(stats.overflow).tolist()
    report["dropped_gaussians"] = int(np.sum(np.asarray(stats.dropped_gaussians)))
    # partition-exactness sentinel: 0 on every band (AND single-chip) ⇒ tier
    # membership is a pure per-gaussian function ⇒ pair partition is exact
    report["per_band_tier_overflow"] = np.asarray(stats.tier_overflow).tolist()
    report["single_tier_overflow"] = int(single.tier_overflow)
    # Pair accounting: rect/shrink/σ-test decisions are all computed on the
    # GLOBAL grid (round 4) and the calibrated capacity covers every eligible
    # splat (round 5), so the sentinel must read 0 on every band AND the
    # single chip, and the per-band pair counts must partition the
    # single-chip total EXACTLY. These are hard asserts, not aspirations.
    clamps = int(np.sum(np.asarray(stats.clamped_rects))) + int(
        single.clamped_rects
    )
    tovf = int(np.sum(np.asarray(stats.tier_overflow))) + int(
        single.tier_overflow
    )
    report["pair_sum_diff"] = int(band_pairs.sum()) - total
    report["clamped_rects"] = clamps
    report["pair_overflow_total"] = int(
        np.sum(np.asarray(stats.overflow))
    ) + int(single.overflow)
    assert tovf == 0, (report["per_band_tier_overflow"], int(single.tier_overflow))
    assert report["pair_sum_diff"] == 0, (int(band_pairs.sum()), total)
    assert clamps == 0, clamps  # no splat at this shape exceeds the K cap
    assert report["pair_overflow_total"] == 0, report["pair_overflow_total"]
    assert report["dropped_gaussians"] == 0, report["dropped_gaussians"]

    # --- 2. end-to-end sharded image probe at reduced res --------------------
    pw, ph = args.probe_res
    probe_cam = gs.Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, pw, ph
    )
    # probe a subsample so the O(pairs×pixels) jnp raster fits host memory
    sub = jax.tree_util.tree_map(lambda x: x[: 65536 // ndev * ndev], model)
    out = render_sharded(sub, probe_cam, cfg, mesh)
    sub_host = jax.device_get(sub)
    img_single = render(sub_host, probe_cam, cfg).image
    err = float(jnp.max(jnp.abs(out.image - img_single)))
    # Error budget: band rasterization evaluates σ in band-LOCAL pixel
    # coordinates ((py − row0) − (my − row0) rounds differently from the
    # single-chip py − my), so α wobbles by ~α·3e-4 for splats near the
    # 0.3-px covariance-dilation floor — a few 1e-4 per pixel. Tier shrinks
    # (partition-variant, see binning.py) can add crop-sized diffs on top;
    # count them on BOTH sides and widen the gate only when they fired.
    proj_sub, _ = _project_and_shade(sub_host, probe_cam, cfg)
    single_probe_clamps = int(
        bin_gaussians(proj_sub, pw, ph, cfg).clamped_rects
    )
    probe_clamps = (
        int(np.sum(np.asarray(out.stats.clamped_rects))) + single_probe_clamps
    )
    report["probe_res"] = [pw, ph]
    report["probe_max_abs_err_vs_single_chip"] = err
    report["probe_clamped_rects"] = probe_clamps
    assert err < (5e-4 if probe_clamps == 0 else 2e-2), (err, probe_clamps)

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
