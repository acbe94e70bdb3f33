"""Benchmark: fwd+bwd on the north-star primary config (1M splats @ 1080p).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The reference publishes no numbers (BASELINE.md); `vs_baseline` is computed
against its only encoded performance design point — the ~60 FPS frame cap at the
default viewport (SDL_Delay(16), /root/reference/src/main.mm:210-211) scaled to
1080p, i.e. baseline = 1920·1080·60 pixels/s — for the *forward* path, which is
what the reference does. The primary reported value is fwd+bwd ms/frame.

Runs on the GPU only (it exits non-zero when JAX finds none). Each phase
(fwd, bwd) is guarded: a failure in one records an error string and the other
still reports, and any failed phase makes the exit code non-zero.
"""

import argparse
import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp


def _phase(errors, name, fn):
    """Run one bench phase; on failure record a compact error and continue."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — report, never crash the bench
        msg = f"{type(e).__name__}: {str(e)[:300]}"
        errors[name] = msg
        traceback.print_exc()
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=8, help="frames scanned inside one jitted dispatch (as the trainer batches steps)")
    ap.add_argument("--sh-degree", type=int, default=1)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--scene", default=None, help="render a PLY scene instead of the synthetic random model (realistic depth-complexity bench config)")
    ap.add_argument("--config5", action="store_true", help="north-star config 5: 3M splats @ 3840x2160 single-chip (capacities come from the same scene calibration as every bench run; the 4K shape needs it — the default fraction-sized big tier overflows 308k deep there)")
    ap.add_argument("--no-calibrate", action="store_true", help="skip scene calibration and bench the generic default capacities")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1

    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.config5:
        args.n, args.width, args.height = 3_000_000, 3840, 2160

    if args.scene:
        from gaussian_splat_tpu.io.ply import load_gaussians

        model = load_gaussians(args.scene)
        args.n = model.num_gaussians
    else:
        key = jax.random.PRNGKey(0)
        model = gs.GaussianModel.random(
            key, args.n, sh_degree=args.sh_degree, extent=2.0,
            scale_range=(0.004, 0.02) if args.config5 else (0.005, 0.02),
        )
    camera = gs.Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
        60.0, args.width, args.height,
    )
    config = gs.RenderConfig(backend=args.backend)
    if not args.no_calibrate:
        # Scene calibration (the deployment model: one compile per scene):
        # pairs_per_gaussian and big_tier_capacity are static capacities that
        # default to generic-safe values; measuring the scene's rect-cell
        # total and big-tier-eligible count sizes them tightly with
        # sentinel-guarded exactness — overflow/tier_overflow are reported
        # below and MUST be 0, in which case the output is bit-identical to
        # the default config (capacities only affect truncation + padding),
        # and every pair-proportional stage stops paying for budget headroom.
        config = gs.calibrate_render_config(model, camera, config)

    # Amortize per-dispatch host↔device overhead by rendering `reps` frames
    # inside ONE jitted scan (the jiggle of the means between frames defeats
    # CSE without changing the workload).
    reps = args.reps
    errors = {}
    stats = gs.binning_stats(model, camera, config)
    if int(stats.overflow) or int(stats.tier_overflow):
        errors["capacity"] = (
            f"overflow={int(stats.overflow)} tier_overflow={int(stats.tier_overflow)}"
        )

    @jax.jit
    def fwd(m):
        def step(carry, i):
            mi = m.replace(means=m.means + 1e-6 * i)
            img = gs.render(mi, camera, config).image
            return carry + img[0, 0, 0], None

        total, _ = jax.lax.scan(step, 0.0, jnp.arange(reps, dtype=jnp.float32))
        return total

    def loss(m):
        return jnp.mean(gs.render(m, camera, config).image ** 2)

    @jax.jit
    def bwd(m):
        def step(carry, i):
            mi = m.replace(means=m.means + 1e-6 * i)
            g = jax.grad(loss)(mi)
            return carry + g.means[0, 0], None

        total, _ = jax.lax.scan(step, 0.0, jnp.arange(reps, dtype=jnp.float32))
        return total

    def median_ms(fn, arg, iters):
        jax.block_until_ready(fn(arg))  # compile + warm
        jax.block_until_ready(fn(arg))
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(arg))
            ts.append((time.perf_counter() - t0) * 1e3 / reps)
        ts.sort()
        return ts[len(ts) // 2]

    fwd_ms = _phase(errors, "fwd", lambda: median_ms(fwd, model, args.iters))
    fwdbwd_ms = (
        None
        if args.fwd_only
        else _phase(errors, "bwd", lambda: median_ms(bwd, model, args.iters))
    )

    pixels = args.width * args.height
    baseline_pixels_per_s = 1920 * 1080 * 60.0  # reference 60 FPS design point
    pixels_per_s = None if fwd_ms is None else pixels / (fwd_ms / 1e3)

    primary_ms = fwd_ms if (args.fwd_only or fwdbwd_ms is None) else fwdbwd_ms
    result = {
        "metric": f"fwd+bwd ms/frame @ {args.n} splats {args.width}x{args.height}",
        "value": None if primary_ms is None else round(primary_ms, 3),
        "unit": "ms",
        "vs_baseline": (
            None
            if pixels_per_s is None
            else round(pixels_per_s / baseline_pixels_per_s, 3)
        ),
        "fwd_ms": None if fwd_ms is None else round(fwd_ms, 3),
        "fwd_bwd_ms": None if fwdbwd_ms is None else round(fwdbwd_ms, 3),
        "fwd_pixels_per_s": (
            None if pixels_per_s is None else round(pixels_per_s)
        ),
        "backend": config.backend,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "pair_budget": config.pair_budget(args.n),
        "num_pairs": int(stats.num_pairs),
        "overflow": int(stats.overflow),
        "tier_overflow": int(stats.tier_overflow),
        "big_tier_capacity": config.big_tier_capacity,
    }
    if args.scene:
        result["scene"] = args.scene
    if errors:
        result["errors"] = errors
    print(json.dumps(result))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
