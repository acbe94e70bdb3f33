"""Proof that the render and train path runs on the GPU.

    python chip_smoke.py                # one card: parity, 1M/1080p render, train
    python chip_smoke.py --four-cards   # only the sharded path, on a 4-card mesh

Prints one line per phase and, as its last line, one JSON object
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
A failed phase raises and the script exits non-zero. With no GPU it exits
non-zero at once, before any work.

Random scenes are made from fixed seeds; the references (`jnp_tile`, the
`reference` oracle) run under `jax.default_matmul_precision("highest")`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

LEAVES = ("means", "quats", "log_scales", "opacity_logits", "sh")
TRITON_CALL = "__gpu$xla.gpu.triton"

# Tolerances, kernel vs jnp_tile at 100k splats / 640x360. Both composite in
# f32 log space; they differ only in summation order. jnp_tile takes each
# tile's prefix as a difference of one GLOBAL cumsum over all pairs, whose
# magnitude reaches ~1e3-1e4 (f32 ulp ~1e-4..1e-3 there), so it is the
# looser of the two.
IMG_TOL = dict(atol=5e-4, rtol=1e-3)  # image and alpha
DEPTH_TOL = dict(atol=5e-3, rtol=1e-3)  # depth ~3-7: same relative bound
# Gradients, as |kernel − jnp_tile| / max|jnp_tile| per leaf. The bulk must
# agree to 5e-3; a few elements may flip the α-clamp gradient mask
# (alpha_raw < alpha_clamp) when a near-opaque splat's α sits within an ulp
# of the clamp — a step in dα that any two implementations resolve
# differently — so up to 1e-4 of elements may reach 6e-2.
GRAD_BULK, GRAD_FRAC, GRAD_MAX = 5e-3, 1e-4, 6e-2
# 64x64 crop of the 1M/1080p frame vs the O(N·H·W) oracle: same bounds as
# the image parity (f32, different summation order: the oracle is a
# cumprod over all splats of the crop).
CROP_TOL = IMG_TOL
# Sharded vs single-card image: every α and every per-tile block walk is
# identical (blocks start at each tile's own segment offset), so only the
# tests' f32 slack is allowed.
SHARD_TOL = dict(atol=3e-6, rtol=1e-5)


# (splats, width, height): parity scene and the full-width scene
PARITY_SCENE = (100_000, 640, 360)
FULL_SCENE = (1_000_000, 1920, 1080)


def assert_kernels(text: str, where: str, kernels) -> None:
    """The lowered program calls the named Triton kernels (no fallback)."""
    missing = [k for k in kernels if k not in text]
    if TRITON_CALL not in text or missing:
        raise AssertionError(f"{where}: Triton kernels {missing or kernels} "
                             "missing from the lowered program")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """Name and power limit of the card, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def scene(n, sh_degree, width, height, seed=0, scale_range=(0.005, 0.02)):
    """The synthetic bench scene: n random splats in a radius-2 volume seen
    from 5 units away at 60° vertical field of view."""
    import gaussian_splat_tpu as gs

    model = gs.GaussianModel.random(
        jax.random.PRNGKey(seed), n, sh_degree=sh_degree, extent=2.0,
        scale_range=scale_range,
    )
    camera = gs.Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, width, height
    )
    return model, camera


def peak_gib() -> float:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**30


def timed(fn, *args, reps=5):
    """(compile seconds, median warm ms, compiled) for a jitted fn."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return compile_s, statistics.median(ts), compiled


def check(failures, ok, what):
    if not ok:
        failures.append(what)


def compare(failures, name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    ok = bool(np.all(np.isfinite(got))) and np.allclose(got, want, **tol)
    check(failures, ok, f"{name} max|err|={err:.3g} outside {tol}")
    return f"{name} max|err|={err:.3g}"


def compare_grads(failures, g_k, g_ref):
    parts = []
    for name in LEAVES:
        a = np.asarray(getattr(g_ref, name))
        b = np.asarray(getattr(g_k, name))
        err = np.abs(b - a) / (np.abs(a).max() + 1e-12)
        frac = float((err > GRAD_BULK).mean())
        mx = float(err.max())
        ok = bool(np.all(np.isfinite(b))) and frac <= GRAD_FRAC and mx < GRAD_MAX
        check(failures, ok, f"grad {name}: frac>{GRAD_BULK}={frac:.3g}, max={mx:.3g}")
        parts.append(f"{name} frac={frac:.2g} max={mx:.2g}")
    return "; ".join(parts)


def phase_parity():
    """Kernels vs jnp_tile at 100k splats / 640x360, on both pipelines."""
    import gaussian_splat_tpu as gs

    n, w, h = PARITY_SCENE
    model, camera = scene(n, 1, w, h, seed=7, scale_range=(0.005, 0.03))
    target = jax.random.uniform(jax.random.PRNGKey(1), (h, w, 3))
    failures = []
    pipelines = {
        # the one-gather pipeline (raster_pairs_sorted) is the default;
        # max_tiles_per_gaussian > 63 disables the packed rect codes and
        # forces the raster_pairs pipeline
        "sorted": gs.RenderConfig(backend="pallas"),
        "raster_pairs": gs.RenderConfig(backend="pallas", max_tiles_per_gaussian=64),
    }
    for label, cfg in pipelines.items():
        ref_cfg = dataclasses.replace(cfg, backend="jnp_tile")

        def fwd(c):
            return jax.jit(lambda m: gs.render(m, camera, c)[:3])

        def grad(c):
            return jax.jit(jax.grad(
                lambda m: jnp.mean(jnp.abs(gs.render(m, camera, c).image - target))
            ))

        out_k = fwd(cfg)(model)
        g_k = grad(cfg)(model)
        with jax.default_matmul_precision("highest"):
            out_r = fwd(ref_cfg)(model)
            g_r = grad(ref_cfg)(model)
        msgs = [
            compare(failures, "image", out_k[0], out_r[0], IMG_TOL),
            compare(failures, "alpha", out_k[1], out_r[1], IMG_TOL),
            compare(failures, "depth", out_k[2], out_r[2], DEPTH_TOL),
        ]
        log("parity", f"{label} fwd vs jnp_tile: " + ", ".join(msgs))
        log("parity", f"{label} grads vs jnp_tile: " + compare_grads(failures, g_k, g_r))
    log("parity", f"peak {peak_gib():.2f} GiB")
    if failures:
        raise AssertionError("parity: " + " | ".join(failures))


def phase_oracle_crop(model, camera, config, image):
    """Tile-aligned 64x64 crop of the 1M/1080p frame vs the oracle.

    The crop is the frame seen through a principal point shifted by
    (x0, y0): the oracle composites the full frame's projected splats with
    means2d − (x0, y0) on a 64x64 viewport. (A separate 64x64 Camera would
    re-project with a viewport-dependent frustum guard, and so differ for
    splats near its edges.) Only splats whose ellipse box reaches the crop
    can touch it, so the oracle runs on that subset."""
    from gaussian_splat_tpu.ops import reference as reference_ops
    from gaussian_splat_tpu.ops.render import _effective_opacities, _project_and_shade

    size = 64
    x0 = int(camera.cx) - size // 2
    x0 -= x0 % config.tile_width
    y0 = int(camera.cy) - size // 2
    y0 -= y0 % config.tile_height

    @jax.jit
    def project(m):
        proj, colors = _project_and_shade(m, camera, config)
        return proj, colors, _effective_opacities(m, proj, config)

    proj, colors, opac = jax.device_get(project(model))
    mx, my = proj.means2d[:, 0], proj.means2d[:, 1]
    rx, ry = proj.extents[:, 0] + 1.0, proj.extents[:, 1] + 1.0
    near = (
        proj.valid & (mx + rx > x0) & (mx - rx < x0 + size)
        & (my + ry > y0) & (my - ry < y0 + size)
    )
    idx = np.nonzero(near)[0]
    ref_cfg = dataclasses.replace(config, backend="reference")
    with jax.default_matmul_precision("highest"):
        img_o, _, _ = jax.jit(
            lambda *a: reference_ops.render_reference(*a, size, size, ref_cfg)
        )(
            proj.means2d[idx] - np.float32([x0, y0]), proj.conics[idx],
            colors[idx], opac[idx], proj.depths[idx], proj.valid[idx],
        )
    crop = np.asarray(image)[y0:y0 + size, x0:x0 + size]
    failures = []
    msg = compare(failures, "crop image", crop, img_o, CROP_TOL)
    log("oracle", f"crop at (x0={x0}, y0={y0}) over {idx.size} splats: {msg}")
    if failures:
        raise AssertionError("oracle crop: " + " | ".join(failures))


def phase_render_and_train():
    """1M splats, SH degree 3, 1920x1080: render, then 5 train steps."""
    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.config import TrainConfig
    from gaussian_splat_tpu.ops.render import binning_stats
    from gaussian_splat_tpu.train.trainer import create_train_state, make_train_step

    model, camera = scene(*FULL_SCENE[:1], 3, *FULL_SCENE[1:])
    config = gs.calibrate_render_config(model, camera, gs.RenderConfig(backend="auto"))
    stats = binning_stats(model, camera, config)
    log("render", f"pairs={int(stats.num_pairs)} overflow={int(stats.overflow)} "
        f"tier_overflow={int(stats.tier_overflow)} clamped={int(stats.clamped_rects)} "
        f"pair_budget={config.pair_budget(model.num_gaussians)}")
    if int(stats.overflow) or int(stats.tier_overflow):
        raise AssertionError("render: calibrated config overflows its capacities")

    render_fn = jax.jit(lambda m, cam: gs.render(m, cam, config)[:3])
    assert_kernels(render_fn.lower(model, camera).as_text(), "render", ["gs_raster_fwd"])
    compile_s, ms, compiled = timed(render_fn, model, camera)
    image, alpha, depth = compiled(model, camera)
    if not bool(jnp.all(jnp.isfinite(image))):
        raise AssertionError("render: non-finite image")
    log("render", f"1M/1080p SH3: compile {compile_s:.1f} s, warm {ms:.3f} ms/frame, "
        f"peak {peak_gib():.2f} GiB, Triton fwd kernel in lowered program")

    phase_oracle_crop(model, camera, config, image)

    tc = TrainConfig()
    step = make_train_step(camera, config, tc)
    target = jnp.clip(image + 0.05, 0.0, 1.0)  # a reachable, nearby target
    state = create_train_state(model, tc)
    assert_kernels(step.lower(state, target).as_text(), "train",
                   ["gs_raster_fwd", "gs_raster_bwd"])
    t0 = time.perf_counter()
    compiled = step.lower(state, target).compile()
    compile_s = time.perf_counter() - t0
    losses, ts = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, loss = compiled(state, target)
        loss = float(loss)
        ts.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"train: non-finite loss {losses}")
    for name in LEAVES:
        if not bool(jnp.all(jnp.isfinite(getattr(state.model, name)))):
            raise AssertionError(f"train: non-finite leaf {name}")
    log("train", f"1M/1080p SH3: compile {compile_s:.1f} s, warm "
        f"{statistics.median(ts[1:]):.3f} ms/step, peak {peak_gib():.2f} GiB, "
        f"losses {[round(x, 6) for x in losses]}, Triton fwd+bwd kernels in lowered step")


def phase_four_cards():
    """Sharded render (both exchanges) and one sharded train step on 4 cards,
    against the single-card render of the same 1M/1080p scene."""
    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.config import TrainConfig
    from gaussian_splat_tpu.ops.render import binning_stats
    from gaussian_splat_tpu.parallel.mesh import make_mesh, shard_model
    from gaussian_splat_tpu.parallel.sharded_render import render_sharded
    from gaussian_splat_tpu.train.trainer import create_train_state, make_train_step

    mesh = make_mesh(4)
    model, camera = scene(*FULL_SCENE[:1], 3, *FULL_SCENE[1:])
    config = gs.calibrate_render_config(
        model, camera, gs.RenderConfig(backend="auto"), mesh_ndev=4
    )
    total = int(binning_stats(model, camera, config).num_pairs)
    single = jax.jit(lambda m: gs.render(m, camera, config).image)(model)
    sharded_model = shard_model(model, mesh)
    failures = []
    for exchange in ("all_gather", "all_to_all"):
        cfg = dataclasses.replace(config, shard_exchange=exchange)
        fn = jax.jit(lambda m, c=cfg: render_sharded(m, camera, c, mesh))
        assert_kernels(fn.lower(sharded_model).as_text(), exchange, ["gs_raster_fwd"])
        compile_s, ms, compiled = timed(fn, sharded_model)
        out = compiled(sharded_model)
        bands = np.asarray(jax.device_get(out.stats.num_pairs))
        dropped = int(np.sum(jax.device_get(out.stats.dropped_gaussians)))
        msg = compare(failures, "image vs single card", out.image, single, SHARD_TOL)
        check(failures, dropped == 0, f"{exchange}: dropped {dropped}")
        check(failures, int(bands.sum()) == total,
              f"{exchange}: band pairs {bands.tolist()} sum != single {total}")
        log("four-cards", f"{exchange}: compile {compile_s:.1f} s, warm {ms:.3f} ms, "
            f"{msg}, dropped={dropped}, band pairs {bands.tolist()} "
            f"(sum {int(bands.sum())}, single {total})")

    tc = TrainConfig()
    step = make_train_step(camera, config, tc, mesh=mesh)
    state = create_train_state(sharded_model, tc)
    t0 = time.perf_counter()
    state, loss = step(state, jnp.clip(single + 0.05, 0.0, 1.0))
    loss = float(loss)
    check(failures, np.isfinite(loss), f"sharded train: loss {loss}")
    log("four-cards", f"sharded train step (all_gather): loss {loss:.6f}, "
        f"first call {time.perf_counter() - t0:.1f} s, peak {peak_gib():.2f} GiB")
    if failures:
        raise AssertionError("four-cards: " + " | ".join(failures))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded render and train step on 4 cards")
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 1

    from gaussian_splat_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    log("card", f"{card} | jax {jax.__version__} | {devices[0].device_kind} "
        f"x{len(devices)} | compile cache {cache}")
    print(card, flush=True)

    if args.four_cards:
        phase_four_cards()
    else:
        phase_parity()
        phase_render_and_train()

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
