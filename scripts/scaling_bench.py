"""Sharded train-step scaling rehearsal on the virtual CPU mesh.

Times the FULL sharded train step — projection, exchange, band binning, raster, loss, backward through
the collectives, optimizer — at D = 1, 2, 4, 8 virtual devices.

What a virtual mesh can and cannot measure: all D "devices" share one host's
cores, so wall-clock does NOT drop with D — speedup is unmeasurable here.
What IS measurable is WORK PRESERVATION: an ideal sharding splits the same
total work into D bands, so T(D) ≈ T(1); every excess in T(D)/T(1) is real
sharding overhead (exchange traffic, capacity padding, per-band fixed costs)
that would also be paid on real chips. We report
    work_preservation(D) = T(1) / T(D)
plus per-band pair balance (the load-imbalance factor that bounds real-mesh
efficiency: a band with 2× the mean pairs caps chip utilization at 50%).

Usage:
    python scripts/scaling_bench.py [--n 200000] [--res 960 528] [--out FILE]
"""

import argparse
import json
import os
import sys
import time

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--res", type=int, nargs=2, default=(960, 528))
    ap.add_argument("--exchange", default="all_gather",
                    choices=["all_gather", "all_to_all"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.config import TrainConfig
    from gaussian_splat_tpu.parallel.mesh import make_mesh, shard_model
    from gaussian_splat_tpu.train.trainer import create_train_state, make_train_step

    W, H = args.res
    camera = gs.Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, W, H
    )
    base_cfg = gs.RenderConfig(backend="jnp_tile", shard_exchange=args.exchange)
    tc = TrainConfig(num_steps=8)
    target = jnp.zeros((H, W, 3))

    rows = []
    t1 = None
    for ndev in (1, 2, 4, 8):
        n = -(-args.n // ndev) * ndev
        model = gs.GaussianModel.random(
            jax.random.PRNGKey(0), n, sh_degree=1, extent=2.0,
            scale_range=(0.005, 0.02),
        )
        # per-D calibration: the compaction cap follows the MEASURED band
        # incidence (no silent drops, no blanket worst-case padding) — the
        # production deployment story (one compile per mesh shape anyway)
        if ndev > 1:
            import dataclasses

            cal = gs.calibrate_render_config(
                model, camera, base_cfg, mesh_ndev=ndev
            )
            cfg = dataclasses.replace(
                base_cfg, shard_capacity_margin=cal.shard_capacity_margin
            )
        else:
            cfg = base_cfg
        mesh = make_mesh(ndev)
        ms = shard_model(model, mesh)
        state = create_train_state(ms, tc)
        step = make_train_step(camera, cfg, tc, mesh=mesh, donate=False)
        state, _ = step(state, target)  # compile + warm
        jax.block_until_ready(state)
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            s2, loss = step(state, target)
            jax.block_until_ready(loss)
            ts.append(time.perf_counter() - t0)
        t = min(ts)
        if ndev == 1:
            t1 = t

        # per-band pair balance at this D (load-imbalance bound on real chips)
        from gaussian_splat_tpu.parallel.sharded_render import sharded_binning_stats

        if ndev > 1:
            stats = sharded_binning_stats(ms, camera, cfg, mesh)
            pairs = np.asarray(stats.num_pairs, dtype=np.float64)
            balance = float(pairs.max() / max(pairs.mean(), 1.0))
            dropped = int(np.asarray(stats.dropped_gaussians).sum())
        else:
            balance = 1.0
            dropped = 0
        rows.append(
            {
                "ndev": ndev,
                "step_s": round(t, 3),
                "work_preservation": round(t1 / t, 3),
                "pair_imbalance_max_over_mean": round(balance, 3),
                # capacity-cap drops at the calibrated margin — must be 0
                # for the compaction to be output-identical on this scene
                "dropped_gaussians": dropped,
                "capacity_margin": cfg.shard_capacity_margin,
            }
        )
        print(rows[-1], flush=True)

    report = {
        "n": args.n,
        "resolution": [W, H],
        "exchange": args.exchange,
        "rows": rows,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
