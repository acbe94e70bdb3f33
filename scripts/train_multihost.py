"""Multi-host sharded training launcher (north-star config 5).

Run ONE copy per host; jax.distributed forms the runtime from
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID (see
parallel/distributed.py), the mesh spans every GPU of every host (host by
host), and the train step shards splats + tile rows
exactly as on a single host — the code path is identical to
tests/test_sharded.py, just over more devices.

Example (per host):
    python scripts/train_multihost.py --ply scene.ply --transforms data/ \
        --steps 5000 --width 3840 --height 2160 --checkpoint-dir ckpt/

Single-host invocation works too (no coordinator env needed).
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True, help="initial scene PLY")
    ap.add_argument("--transforms", default=None,
                    help="transforms.json dataset dir (else synthetic target)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--out", default="trained.ply")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--steps-per-dispatch", type=int, default=4,
                    help="lax.scan'd steps per jitted call (dispatch amortization)")
    args = ap.parse_args(argv)

    import jax

    from gaussian_splat_tpu.parallel.distributed import init_distributed, make_pod_mesh

    multi = init_distributed()
    if jax.process_index() == 0:
        print(f"processes={jax.process_count()} devices={len(jax.devices())} multi={multi}")

    import jax.numpy as jnp
    import numpy as np

    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.config import RenderConfig, TrainConfig
    from gaussian_splat_tpu.io.ply import load_gaussians, save_gaussians
    from gaussian_splat_tpu.parallel.mesh import shard_model
    from gaussian_splat_tpu.train.checkpoint import restore_checkpoint, save_checkpoint
    from gaussian_splat_tpu.train.trainer import create_train_state, make_train_step

    mesh = make_pod_mesh()
    ndev = len(jax.devices())

    model = load_gaussians(args.ply)
    # pad N to the mesh size
    n = model.num_gaussians
    pad = (-n) % ndev
    if pad:
        model = jax.tree_util.tree_map(
            lambda x: jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]),
            model,
        )
        # padded slots must be culled outright, not just invisible: zero-filled
        # rows (scale=exp(0)=1 at the origin) would pass projection culling and
        # burn pair budget + big-tier slots every step. Degenerate scales plus
        # transparent opacity keep them out of the pipeline entirely.
        model = model.replace(
            opacity_logits=model.opacity_logits.at[n:].set(-20.0),
            log_scales=model.log_scales.at[n:].set(-20.0),
        )
    model = shard_model(model, mesh)

    # ≥2 hosts: default the exchange to the sparse all-to-all (north star);
    # single host keeps the dense all_gather (cheaper at ≤8 devices)
    exchange = "all_to_all" if multi else "all_gather"
    render_cfg = RenderConfig(backend="auto", shard_exchange=exchange)
    tc = TrainConfig(num_steps=args.steps, steps_per_dispatch=args.steps_per_dispatch)

    state = create_train_state(model, tc)
    if args.checkpoint_dir:
        restored = restore_checkpoint(args.checkpoint_dir, state)
        if restored is not None:
            state = restored
            if jax.process_index() == 0:
                print(f"resumed from step {int(state.step)}")

    K = max(1, tc.steps_per_dispatch)
    rng = np.random.default_rng(0)  # same stream on every process → same views

    if args.transforms:
        # real multi-view training: random view per step, each view rendered
        # sharded over the pod mesh (north-star config 5 end-to-end)
        from gaussian_splat_tpu.io.dataset_io import load_transforms
        from gaussian_splat_tpu.train.trainer import make_multiview_train_step

        ds = load_transforms(args.transforms)
        step_fn = make_multiview_train_step(ds, render_cfg, tc, mesh=mesh)

        def next_arg():
            v = rng.integers(ds.num_views, size=K).astype(np.int32)
            return jnp.asarray(v if K > 1 else v[0])

    else:
        from gaussian_splat_tpu.camera import orbit_camera

        camera = orbit_camera(5.0, 30.0, 20.0, width=args.width, height=args.height)
        target = jnp.zeros((args.height, args.width, 3))
        step_fn = make_train_step(camera, render_cfg, tc, mesh=mesh)

        def next_arg():
            return target

    for i in range(int(state.step), args.steps, K):
        state, loss = step_fn(state, next_arg())
        if (i // K) % max(1, args.log_every // K) == 0 and jax.process_index() == 0:
            print(f"step {i}: loss {float(loss):.6f}")
        if args.checkpoint_dir and (i + K) % args.checkpoint_every < K:
            save_checkpoint(args.checkpoint_dir, state)

    if jax.process_index() == 0:
        save_gaussians(args.out, jax.device_get(state.model))
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
