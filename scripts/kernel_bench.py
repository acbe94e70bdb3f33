"""Raster-kernel decisions on the GPU: each hand-written kernel against what
XLA compiles from the plain version (`ops/tile_raster.composite_pairs`), at
1M splats / 1080p (the plain version at the largest scale that fits), plus
the kernel variants, the per-splat gradient reduction variants, and one
profiled train step.

    python scripts/kernel_bench.py                 # writes chiprun_out/kernel_bench.json

Every time is the median of several warm calls, each ending in
block_until_ready, on one process and one card; the JSON names the card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import gaussian_splat_tpu as gs  # noqa: E402
from gaussian_splat_tpu.ops import pallas_raster as pr  # noqa: E402
from gaussian_splat_tpu.ops.binning import bin_gaussians, rect_codes  # noqa: E402
from gaussian_splat_tpu.ops.render import _effective_opacities, _project_and_shade  # noqa: E402
from gaussian_splat_tpu.ops.tile_raster import composite_pairs  # noqa: E402

SCALES = [  # (splats, width, height), largest first
    (1_000_000, 1920, 1080),
    (1_000_000, 960, 540),
    (250_000, 960, 540),
    (100_000, 640, 360),
]


def median_ms(fn, *args, reps=7):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def scene(n, width, height):
    model = gs.GaussianModel.random(
        jax.random.PRNGKey(0), n, sh_degree=3, extent=2.0, scale_range=(0.005, 0.02)
    )
    camera = gs.Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, width, height
    )
    config = gs.calibrate_render_config(model, camera, gs.RenderConfig(backend="pallas"))
    return model, camera, config


def pair_inputs(model, camera, config):
    """The one-gather pipeline up to the raster call (as render_tiled_pallas)."""
    w, h = camera.width, camera.height
    num_tiles = config.num_tiles(w, h)

    @jax.jit
    def prep(m):
        proj, colors = _project_and_shade(m, camera, config)
        opac = _effective_opacities(m, proj, config)
        feats10 = jnp.concatenate(
            [proj.means2d, proj.conics, colors, proj.depths[:, None], opac[:, None]], 1
        )
        code, clamped, tier = rect_codes(proj, w, h, config)
        order = jnp.argsort(jnp.where(proj.valid, proj.depths, jnp.inf))
        table = jnp.concatenate(
            [feats10, jax.lax.bitcast_convert_type(code, jnp.float32)[:, None]], 1
        )[order]
        b = bin_gaussians(
            proj, w, h, config, order=order,
            code_sorted=jax.lax.bitcast_convert_type(table[:, 10], jnp.uint32),
            clamped_precomputed=clamped, tier_overflow_precomputed=tier,
            table_sorted=table[:, :10],
        )
        n = feats10.shape[0]
        ranks = jnp.where(b.pair_tile < num_tiles, b.pair_gauss, n)
        return pr._gather_sorted_t(table[:, :10], ranks), b.tile_offsets, b.tile_counts, b.pair_tile, ranks

    static = pr.RasterStatics(
        tile_w=config.tile_width, tile_h=config.tile_height,
        tiles_x=config.tiles_x(w), tiles_y=config.tiles_y(h),
        alpha_clamp=config.alpha_clamp, alpha_skip=config.alpha_skip,
        sigma_cutoff=config.sigma_cutoff, trans_eps=config.transmittance_eps,
        sat_check=config.sat_check,
    )
    return (*prep(model), static)


def kernel_fns(static, offsets, counts):
    fwd = jax.jit(lambda f: pr._raster_forward(f, offsets, counts, static))

    @jax.jit
    def fwd_bwd(f, cot):
        out, vjp = jax.vjp(lambda x: pr._raster(x, offsets, counts, static), f)
        return out, vjp(cot)[0]

    return fwd, fwd_bwd


def plain_fns(config, static, offsets, pair_tile):
    nt = static.tiles_x * static.tiles_y
    npix = static.tile_w * static.tile_h

    def out(f):
        ft = f.T
        rgbd, t_final = composite_pairs(
            pair_tile, ft[:, 0:2], ft[:, 2:5], ft[:, 5:9], ft[:, 9],
            pair_tile < nt, offsets, static.tiles_x, nt, config,
        )
        rows = jnp.concatenate([jnp.swapaxes(rgbd, 1, 2), t_final[:, None]], 1)
        return jnp.pad(rows, ((0, 0), (0, pr.NROW - 5), (0, 0))).reshape(nt * pr.NROW, npix)

    fwd = jax.jit(out)

    @jax.jit
    def fwd_bwd(f, cot):
        o, vjp = jax.vjp(out, f)
        return o, vjp(cot)[0]

    return fwd, fwd_bwd


def attempt(results, key, fn):
    try:
        results[key] = fn()
    except Exception as e:  # noqa: BLE001 — an OOM at one scale is a finding
        results[key] = f"failed: {type(e).__name__}: {str(e)[:200]}"
    print(key, results[key], flush=True)


def kernel_vs_plain(res):
    """Kernel and plain rasterization on the same pair lists, per scale."""
    plain_fit = None
    for n, w, h in SCALES:
        tag = f"{n}@{w}x{h}"
        model, camera, config = scene(n, w, h)
        feats, offsets, counts, pair_tile, ranks, static = pair_inputs(model, camera, config)
        cot = jax.random.normal(jax.random.PRNGKey(1), (static.tiles_x * static.tiles_y * pr.NROW, 512))
        kf, kfb = kernel_fns(static, offsets, counts)
        attempt(res, f"kernel_fwd_ms {tag}", lambda: median_ms(kf, feats))
        attempt(res, f"kernel_fwd_bwd_ms {tag}", lambda: median_ms(kfb, feats, cot))
        res[f"pairs {tag}"] = int(jnp.sum(counts))
        if plain_fit is None:
            pf, pfb = plain_fns(config, static, offsets, pair_tile)
            attempt(res, f"plain_fwd_ms {tag}", lambda: median_ms(pf, feats))
            attempt(res, f"plain_fwd_bwd_ms {tag}", lambda: median_ms(pfb, feats, cot))
            if isinstance(res[f"plain_fwd_bwd_ms {tag}"], float):
                plain_fit = tag
                o_k, g_k = kfb(feats, cot)
                o_p, g_p = pfb(feats, cot)
                res[f"max|kernel-plain| out {tag}"] = float(jnp.max(jnp.abs(o_k - o_p)))
                res[f"max|kernel-plain| grad/scale {tag}"] = float(
                    jnp.max(jnp.abs(g_k - g_p)) / jnp.max(jnp.abs(g_p))
                )
            jax.clear_caches()
        if n == SCALES[0][0] and w == SCALES[0][1]:
            variants(res, feats, offsets, counts, ranks, static, cot)
        if plain_fit is not None:
            break
    res["plain_largest_fit"] = plain_fit


def variants(res, feats, offsets, counts, ranks, static, cot):
    """Launch shapes at 1M/1080p; the gradient reduction's repeatability."""
    defaults = (pr.FWD_WARPS, pr.SAT_CHUNK, pr.BWD_BLOCK, pr.BWD_WARPS, pr.NUM_STAGES)
    try:
        for wps, chunk in ((2, 32), (4, 32), (8, 32), (4, 16), (4, 64)):
            pr.FWD_WARPS, pr.SAT_CHUNK = wps, chunk
            kf, _ = kernel_fns(static, offsets, counts)
            attempt(res, f"fwd warps={wps} sat_chunk={chunk} ms", lambda: median_ms(kf, feats))
        pr.FWD_WARPS, pr.SAT_CHUNK = defaults[:2]
        fwd_out = jax.jit(lambda f: pr._raster_forward(f, offsets, counts, static))(feats)
        for g, wps, stages in ((4, 4, 2), (4, 8, 2), (8, 4, 2), (8, 8, 2), (8, 16, 2),
                               (4, 16, 2), (8, 8, 1), (8, 8, 3)):
            pr.BWD_BLOCK, pr.BWD_WARPS, pr.NUM_STAGES = g, wps, stages
            kb = jax.jit(lambda f, o, c: pr._raster_backward(f, offsets, counts, o, c, static))
            attempt(res, f"bwd G={g} warps={wps} stages={stages} ms",
                    lambda: median_ms(kb, feats, fwd_out, cot))
    finally:
        (pr.FWD_WARPS, pr.SAT_CHUNK, pr.BWD_BLOCK, pr.BWD_WARPS, pr.NUM_STAGES) = defaults

    kb = jax.jit(lambda f, o, c: pr._raster_backward(f, offsets, counts, o, c, static))
    d_pairs = kb(feats, fwd_out, cot)
    reduce = jax.jit(lambda d: pr._sum_by_rank(d, ranks, SCALES[0][0]))
    attempt(res, "reduce segment_sum ms", lambda: median_ms(reduce, d_pairs))
    a, b = reduce(d_pairs), reduce(d_pairs)
    res["reduce bitwise repeatable"] = bool(jnp.array_equal(a, b))
    res["reduce max diff / max"] = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(a)))
    res["bwd kernel bitwise repeatable"] = bool(
        jnp.array_equal(kb(feats, fwd_out, cot), kb(feats, fwd_out, cot))
    )


def end_to_end(res):
    """gs.render fwd and fwd+bwd, kernels vs jnp_tile, per scale."""
    plain_done = False
    for n, w, h in SCALES:
        tag = f"{n}@{w}x{h}"
        model, camera, config = scene(n, w, h)
        for backend in ("pallas", "jnp_tile"):
            if backend == "jnp_tile" and plain_done:
                continue
            cfg = dataclasses.replace(config, backend=backend)
            f = jax.jit(lambda m, c=cfg: gs.render(m, camera, c).image)
            g = jax.jit(jax.grad(lambda m, c=cfg: jnp.mean(gs.render(m, camera, c).image ** 2)))
            attempt(res, f"e2e {backend} fwd_ms {tag}", lambda: median_ms(f, model))
            attempt(res, f"e2e {backend} fwd_bwd_ms {tag}", lambda: median_ms(g, model))
            if backend == "jnp_tile" and isinstance(res[f"e2e {backend} fwd_bwd_ms {tag}"], float):
                plain_done = True
            jax.clear_caches()
        if plain_done:
            break


def profile_train_step(res, out_dir):
    """Device time by operation for one 1M/1080p train step."""
    from gaussian_splat_tpu.config import TrainConfig
    from gaussian_splat_tpu.train.trainer import create_train_state, make_train_step

    model, camera, config = scene(*SCALES[0])
    config = dataclasses.replace(config, backend="auto")
    tc = TrainConfig()
    step = make_train_step(camera, config, tc)
    state = create_train_state(model, tc)
    target = jnp.full((camera.height, camera.width, 3), 0.5)
    for _ in range(3):
        state, loss = step(state, target)
    jax.block_until_ready(loss)
    trace_dir = os.path.join(out_dir, "trace_train_step")
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            state, loss = step(state, target)
        jax.block_until_ready(loss)
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    by_name = collections.Counter()
    busy = []
    res["trace lines"] = [
        f"{p.name} | {ln.name}" for p in prof.planes for ln in p.lines
    ][:60]
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                by_name[ev.name] += ev.duration_ns
                busy.append((ev.start_ns, ev.end_ns))
    busy.sort()
    total, cur_s, cur_e = 0, None, None
    for s, e in busy:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    window = (busy[-1][1] - busy[0][0]) if busy else 0
    res["trace steps"] = 3
    res["trace device busy ms per step"] = total / 3e6
    res["trace window ms per step"] = window / 3e6
    res["trace top ops ms per step"] = {
        k[:80]: v / 3e6 for k, v in by_name.most_common(25)
    }
    shutil.rmtree(trace_dir, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "kernel_bench.json"))
    ap.add_argument("--skip", default="", help="comma list of: plain,e2e,trace")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_bench: needs a GPU")
    from gaussian_splat_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    res = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "jax": jax.__version__}
    print(res, flush=True)
    skip = set(filter(None, args.skip.split(",")))
    if "plain" not in skip:
        kernel_vs_plain(res)
    if "e2e" not in skip:
        end_to_end(res)
    if "trace" not in skip:
        profile_train_step(res, os.path.dirname(args.out))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
