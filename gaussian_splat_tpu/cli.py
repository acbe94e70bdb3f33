"""Command-line interface — the config/flag system the reference lacks
(everything there is hardcoded: PLY path at main.mm:69-70, window size at
main.mm:22-23, OIT mode at instanced_splat_renderer.mm:38, ...).

Subcommands:
  render  — render a PLY scene to a PNG from an orbit pose
  view    — serve the interactive HTTP viewer for a PLY scene
  train   — fit a scene to target image(s)
  info    — print scene statistics for a PLY

Usage: python -m gaussian_splat_tpu.cli <subcommand> [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _add_render_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", default="auto", choices=["auto", "pallas", "jnp_tile", "reference"])
    p.add_argument("--tile-width", type=int, default=32)
    p.add_argument("--tile-height", type=int, default=16)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--background", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--pairs-per-gaussian", type=float, default=4.0)
    p.add_argument("--antialiased", action="store_true",
                   help="gsplat antialiased mode (opacity compensation)")
    p.add_argument("--no-sat-check", action="store_true",
                   help="disable the kernels' early-saturation exit: exact "
                        "tau=0 compositing, slower on saturating scenes")
    p.add_argument("--aabb-clip", type=float, default=None,
                   help="drop splats with any |coord| >= R (reference uses 5, "
                        "instanced_splat_renderer.mm:383-387)")


def _render_config(args):
    from gaussian_splat_tpu.config import RenderConfig

    return RenderConfig(
        backend=args.backend,
        tile_width=args.tile_width,
        tile_height=args.tile_height,
        sh_degree=args.sh_degree,
        background=tuple(args.background),
        pairs_per_gaussian=args.pairs_per_gaussian,
        antialiased=getattr(args, "antialiased", False),
        sat_check=not getattr(args, "no_sat_check", False),
    )


def _load_model(args):
    from gaussian_splat_tpu.io.ply import load_gaussians

    model = load_gaussians(args.ply)
    if getattr(args, "aabb_clip", None):
        model = model.aabb_filter(args.aabb_clip)
    return model


def cmd_render(args) -> int:
    from gaussian_splat_tpu.camera import orbit_camera
    from gaussian_splat_tpu.ops.render import render
    from gaussian_splat_tpu.viewer.viewer import to_uint8

    model = _load_model(args)
    cam = orbit_camera(
        args.radius, args.azimuth, args.elevation,
        width=args.width, height=args.height,
    )
    out = render(model, cam, _render_config(args))
    from PIL import Image

    Image.fromarray(to_uint8(out.image)).save(args.out)
    print(f"rendered {model.num_gaussians} splats -> {args.out}")
    return 0


def cmd_view(args) -> int:
    from gaussian_splat_tpu.viewer.viewer import Viewer

    model = _load_model(args)
    viewer = Viewer(
        model,
        _render_config(args),
        width=args.width,
        height=args.height,
        show_overlay=not args.no_overlay,
        hot_reload=args.hot_reload,
        lod_fraction=args.lod,
        lod_pair_budget=args.lod_pairs,
    )
    print(f"serving {model.num_gaussians} splats at http://{args.host}:{args.port}/")
    viewer.serve(host=args.host, port=args.port)
    return 0


def cmd_train(args) -> int:
    import numpy as np
    from PIL import Image

    from gaussian_splat_tpu.camera import orbit_camera
    from gaussian_splat_tpu.config import TrainConfig
    from gaussian_splat_tpu.io.ply import save_gaussians
    from gaussian_splat_tpu.train.trainer import fit

    model = _load_model(args)
    target = np.asarray(Image.open(args.target).convert("RGB"), np.float32) / 255.0
    cam = orbit_camera(
        args.radius, args.azimuth, args.elevation,
        width=target.shape[1], height=target.shape[0],
    )
    tc = TrainConfig(num_steps=args.steps, checkpoint_dir=args.checkpoint_dir)
    fitted, history = fit(model, cam, target, _render_config(args), tc,
                          callback=lambda i, l, s: print(f"step {i}: loss {l:.5f}"))
    save_gaussians(args.out, fitted)
    print(f"trained {args.steps} steps, final loss {history[-1]:.5f} -> {args.out}")
    return 0


def cmd_turntable(args) -> int:
    from gaussian_splat_tpu.viewer.viewer import Viewer

    model = _load_model(args)
    viewer = Viewer(model, _render_config(args), width=args.width, height=args.height)
    viewer.orbit_turntable(
        n_frames=args.frames,
        radius=args.radius,
        elevation_deg=args.elevation,
        out_dir=args.out_dir,
    )
    print(f"wrote {args.frames} frames to {args.out_dir}/")
    return 0


def cmd_validate(args) -> int:
    """Cross-check the fast backends against the oracle on a small crop of the
    scene — the trust-but-verify command (reference has no equivalent; its only
    verification is visual inspection, SURVEY §4)."""
    import numpy as np

    from gaussian_splat_tpu.camera import orbit_camera
    from gaussian_splat_tpu.ops.render import render

    model = _load_model(args)
    if model.num_gaussians > args.sample:
        import jax

        idx = np.random.default_rng(0).choice(
            model.num_gaussians, args.sample, replace=False
        )
        import jax.numpy as jnp

        model = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)[idx]), model)
    cam = orbit_camera(args.radius, 30.0, 20.0, width=160, height=120)
    cfg_ref = _render_config(args)
    import dataclasses

    ref = render(model, cam, dataclasses.replace(cfg_ref, backend="reference")).image
    ok = True
    for be in ["jnp_tile", "pallas"]:
        img = render(model, cam, dataclasses.replace(cfg_ref, backend=be)).image
        err = float(np.abs(np.asarray(img) - np.asarray(ref)).max())
        status = "OK " if err < args.tol else "FAIL"
        ok &= err < args.tol
        print(f"{status} {be:<10} max|Δ| vs oracle = {err:.2e} (tol {args.tol:.0e})")
    return 0 if ok else 1


def cmd_info(args) -> int:
    import numpy as np

    model = _load_model(args)
    stats = {
        "num_gaussians": model.num_gaussians,
        "sh_degree": model.sh_degree,
        "means_min": np.asarray(model.means).min(0).tolist(),
        "means_max": np.asarray(model.means).max(0).tolist(),
        "opacity_mean": float(np.asarray(model.opacities).mean()),
        "scale_mean": float(np.asarray(model.scales).mean()),
    }
    print(json.dumps(stats, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gaussian_splat_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a PLY to a PNG")
    p.add_argument("ply")
    p.add_argument("--out", default="render.png")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=20.0)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive HTTP viewer")
    p.add_argument("ply")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--no-overlay", action="store_true",
                   help="disable the grid/axes overlay (toggle live with 'g')")
    p.add_argument("--lod", type=float, default=0.0,
                   help="render the top-LOD fraction of splats while the "
                        "camera is being dragged (0 = always full model)")
    p.add_argument("--lod-pairs", type=float, default=0.0,
                   help="pair-budget-aware drag LoD: bound the dragged "
                        "frame's tile-pair cost to this fraction of the "
                        "full frame's (frame time is pair-proportional; "
                        "takes precedence over --lod)")
    p.add_argument("--hot-reload", action="store_true",
                   help="poll the Pallas kernel module every frame and hot-swap it")
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("train", help="fit a scene to a target image")
    p.add_argument("ply")
    p.add_argument("--target", required=True, help="target image (PNG/JPEG)")
    p.add_argument("--out", default="trained.ply")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=20.0)
    p.add_argument("--checkpoint-dir", default=None)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("turntable", help="render an orbit to PNG frames")
    p.add_argument("ply")
    p.add_argument("--out-dir", default="turntable")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--elevation", type=float, default=20.0)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_turntable)

    p = sub.add_parser("validate", help="cross-check backends vs the oracle")
    p.add_argument("ply")
    p.add_argument("--sample", type=int, default=2000,
                   help="subsample to this many splats (oracle is O(N·H·W))")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--tol", type=float, default=1e-3)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("info", help="scene statistics")
    p.add_argument("ply")
    p.add_argument("--aabb-clip", type=float, default=None)
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
