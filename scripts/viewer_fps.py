"""Interactive-viewer FPS measurement on a PLY artifact.

The reference's product is dragging a 2.5M-splat truck PLY interactively
(/root/reference/src/main.mm:69-70 + the trackball loop). This measures the
same interaction pattern headlessly on a trained artifact: orbit the
trackball while "dragging" (LoD subset active, like `cli view --lod`) and
while idle (full model), reporting FPS for both. Writes JSON to stdout.

Run: PYTHONPATH=... python scripts/viewer_fps.py scenes/fitted_2p5m.ply
"""

import json
import sys
import time


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "scenes/fitted_2p5m.ply"
    lod = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25

    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.io.ply import load_gaussians
    from gaussian_splat_tpu.viewer.viewer import Viewer

    model = load_gaussians(path)
    cfg = gs.RenderConfig(backend="auto")
    # the deployment model: one calibration per scene (exactness guarded by
    # the overflow/tier sentinels)
    cam0 = gs.Camera.from_lookat(
        (0.0, 2.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0, 1280, 720
    )
    cfg = gs.calibrate_render_config(model, cam0, cfg)
    v = Viewer(model, cfg, width=1280, height=720, lod_fraction=lod)

    def run(frames, dragging):
        if dragging:
            v.trackball.handle_mouse_down(400, 300, 0)
        # warm both jit paths
        v._interacting_until = time.monotonic() + 1e9 if dragging else 0.0
        v.render_frame()
        v.render_frame()
        t0 = time.perf_counter()
        for i in range(frames):
            if dragging:
                v.trackball.handle_mouse_move(400 + 4 * (i + 1), 300 + (i % 7))
                v._interacting_until = time.monotonic() + 1e9
            else:
                v._interacting_until = 0.0
            v.render_frame()
        dt = time.perf_counter() - t0
        if dragging:
            v.trackball.handle_mouse_up()
        return frames / dt

    fps_drag = run(30, dragging=True)
    fps_idle = run(15, dragging=False)

    # Device-side frame rate: render + block, no host pull — the renderer's
    # own cost, next to the end-to-end numbers above (which include moving
    # each 720p frame to the host).
    import jax

    model_lod = v._model_lod if v._model_lod is not None else model
    cam = v.trackball.camera(1280, 720)

    def dev_fps(m, frames):
        out = v._render_jit(m, cam)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(frames):
            out = v._render_jit(m, cam)
            jax.block_until_ready(out)
        return frames / (time.perf_counter() - t0)

    fps_dev_lod = dev_fps(model_lod, 30)
    fps_dev_full = dev_fps(model, 15)
    result = {
        "scene": path,
        "n": model.num_gaussians,
        "resolution": [1280, 720],
        "lod_fraction": lod,
        "fps_dragging_lod": round(fps_drag, 1),
        "fps_idle_full": round(fps_idle, 1),
        "fps_device_lod": round(fps_dev_lod, 1),
        "fps_device_full": round(fps_dev_full, 1),
    }

    if "--compare" in sys.argv:
        # Impact-ranked lod(f) vs pair-budget LoD at MATCHED pair spend:
        # same tile-pair cost at this pose, so FPS should be comparable and
        # PSNR (vs the full render, both over black) measures which subset
        # spends the pairs better. A third aggressive point (10% budget)
        # shows the latency bound the budget gives directly.
        import numpy as np
        from gaussian_splat_tpu.ops.render import measure_pair_costs

        def psnr(a, b):
            mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
            return 99.0 if mse == 0 else 10.0 * np.log10(1.0 / mse)

        full_img = np.asarray(jax.device_get(v._render_jit(model, cam)[0]))
        costs = np.asarray(measure_pair_costs(model, cam0, cfg))
        # (measured contributions — measure_splat_contributions — were also
        # compared: 13.0 dB density-ordered / 9.1 dB value-ordered at 48%/10%
        # budgets, both beaten by the impact value; docs/viewer_lod_compare*.json)
        tot = float(np.maximum(costs, 1).sum())

        def point(sub, tag):
            c = float(np.asarray(measure_pair_costs(sub, cam0, cfg)).sum())
            img = np.asarray(jax.device_get(v._render_jit(sub, cam)[0]))
            result[tag] = {
                "n": sub.num_gaussians,
                "pair_cost": int(c),
                "pair_cost_share": round(c / tot, 4),
                "fps_device": round(dev_fps(sub, 20), 1),
                "psnr_vs_full_db": round(psnr(img, full_img), 2),
            }
            return c

        c_imp = point(model_lod, "impact_lod")
        match = c_imp / tot
        # (density — knapsack value/cost — orderings were measured once and
        # recorded as negative results: 4.09 dB heuristic / 13.01 dB
        # measured-contribution at the matched budget, vs 29.7 dB for the
        # value orderings below; density inverts the ranking on occluding
        # fog stacks. docs/viewer_lod_compare*.json)
        # value-ordered admission under the budget with the shipped default
        # value (impact = opacity × world area, lod()'s ranking) — at the
        # matched budget and at an aggressive 10% budget
        point(model.lod_pair_budget(match, costs), "value_impact_matched")
        point(model.lod_pair_budget(0.10, costs), "value_impact_0.10")
        result["full_pair_cost"] = int(costs.sum())

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
