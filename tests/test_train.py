"""Training loop: loss sanity, single-image fit convergence, checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig, TrainConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.render import render
from gaussian_splat_tpu.train.loss import l1, photometric_loss, ssim
from gaussian_splat_tpu.train.trainer import (
    create_train_state,
    fit,
    make_train_step,
)


def test_ssim_identity_is_one():
    img = jax.random.uniform(jax.random.PRNGKey(0), (32, 32, 3))
    assert float(ssim(img, img)) > 0.9999


def test_ssim_decreases_with_noise():
    img = jax.random.uniform(jax.random.PRNGKey(0), (32, 32, 3))
    noisy = img + 0.3 * jax.random.normal(jax.random.PRNGKey(1), img.shape)
    assert float(ssim(img, noisy)) < float(ssim(img, img))


def test_photometric_loss_zero_at_identity():
    img = jax.random.uniform(jax.random.PRNGKey(2), (32, 32, 3))
    assert abs(float(photometric_loss(img, img))) < 1e-5
    assert float(photometric_loss(img, jnp.zeros_like(img))) > 0.01


def test_train_step_reduces_loss():
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 64, 64)
    cfg = RenderConfig(backend="jnp_tile")
    # target: render of a "ground truth" scene
    gt = GaussianModel.random(jax.random.PRNGKey(0), 40, sh_degree=0, extent=0.8)
    target = render(gt, cam, cfg).image
    # init: perturbed copy
    init = gt.replace(
        means=gt.means + 0.05 * jax.random.normal(jax.random.PRNGKey(1), gt.means.shape),
        opacity_logits=gt.opacity_logits - 0.5,
    )
    tc = TrainConfig(num_steps=30, ssim_weight=0.2)
    state = create_train_state(init, tc)
    step = make_train_step(cam, cfg, tc, donate=False)
    _, loss0 = step(state, target)
    for _ in range(30):
        state, loss = step(state, target)
    assert float(loss) < float(loss0) * 0.8, (float(loss0), float(loss))


def test_fit_api():
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 48, 48)
    cfg = RenderConfig(backend="jnp_tile")
    gt = GaussianModel.random(jax.random.PRNGKey(3), 20, sh_degree=0, extent=0.6)
    target = render(gt, cam, cfg).image
    model = gt.replace(opacity_logits=gt.opacity_logits - 1.0)
    fitted, history = fit(
        model, cam, target, cfg, TrainConfig(num_steps=20, ssim_weight=0.0),
        log_every=5,
    )
    assert len(history) >= 2
    assert history[-1] < history[0]


def test_checkpoint_roundtrip(tmp_path):
    from gaussian_splat_tpu.train.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    model = GaussianModel.random(jax.random.PRNGKey(4), 16, sh_degree=0)
    tc = TrainConfig()
    state = create_train_state(model, tc)
    state = state._replace(step=jnp.int32(7))
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, state)
    assert latest_step(d) == 7
    restored = restore_checkpoint(d, state)
    assert int(restored.step) == 7
    np.testing.assert_allclose(restored.model.means, state.model.means)
    # optimizer state restored too
    leaves_a = jax.tree_util.tree_leaves(restored.opt_state)
    leaves_b = jax.tree_util.tree_leaves(state.opt_state)
    assert len(leaves_a) == len(leaves_b)


# ---------------------------------------------------------------------------
# Round-2 additions: scanned dispatch, lr decay, SH warmup (VERDICT item 7)
# ---------------------------------------------------------------------------


def _fit_scene(seed=0):
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 64, 64)
    cfg = RenderConfig(backend="jnp_tile")
    gt = GaussianModel.random(jax.random.PRNGKey(seed), 40, sh_degree=0, extent=0.8)
    target = render(gt, cam, cfg).image
    model = GaussianModel.random(jax.random.PRNGKey(seed + 1), 40, sh_degree=0, extent=0.8)
    return cam, cfg, model, target


def test_scanned_dispatch_matches_stepwise():
    """K scanned steps per dispatch must compute the same optimization
    trajectory as K single-step dispatches."""
    cam, cfg, model, target = _fit_scene()
    tc1 = TrainConfig(num_steps=4, steps_per_dispatch=1, lr_means_final=0.0)
    tc4 = TrainConfig(num_steps=4, steps_per_dispatch=4, lr_means_final=0.0)
    m1, _ = fit(model, cam, target, cfg, tc1, log_every=1)
    m4, _ = fit(model, cam, target, cfg, tc4, log_every=1)
    for name in ["means", "quats", "log_scales", "opacity_logits", "sh"]:
        np.testing.assert_allclose(
            np.asarray(getattr(m1, name)),
            np.asarray(getattr(m4, name)),
            atol=1e-6,
            rtol=1e-5,
            err_msg=name,
        )


def test_means_lr_decay_slows_position_updates():
    """With an aggressive decay, late position updates must be far smaller
    than early ones (3DGS exponential means-lr schedule)."""
    import optax
    from gaussian_splat_tpu.train.trainer import make_optimizer

    tc = TrainConfig(num_steps=100, lr_means=1e-2, lr_means_final=1e-6,
                     lr_decay_steps=100)
    tx = make_optimizer(tc)
    model = GaussianModel.random(jax.random.PRNGKey(0), 16, sh_degree=0)
    opt_state = tx.init(model)
    g = jax.tree_util.tree_map(jnp.ones_like, model)
    first = None
    for i in range(100):
        updates, opt_state = tx.update(g, opt_state, model)
        if i == 0:
            first = float(jnp.abs(updates.means).mean())
    last = float(jnp.abs(updates.means).mean())
    assert last < first * 1e-2  # 1e-4 lr ratio, Adam-normalized
    # non-decayed groups hold steady
    assert float(jnp.abs(updates.sh).mean()) > 0.5 * tc.lr_sh


def test_sh_warmup_masks_bands():
    from gaussian_splat_tpu.train.trainer import apply_sh_warmup

    tc = TrainConfig(sh_warmup_every=10)
    model = GaussianModel.random(jax.random.PRNGKey(0), 8, sh_degree=3)
    model = model.replace(sh=jnp.ones_like(model.sh))
    m0 = apply_sh_warmup(model, jnp.int32(0), tc)  # only band 0 (DC)
    assert float(m0.sh[:, 0].min()) == 1.0
    assert float(jnp.abs(m0.sh[:, 1:]).max()) == 0.0
    m1 = apply_sh_warmup(model, jnp.int32(10), tc)  # bands ≤ 1
    assert float(m1.sh[:, 1:4].min()) == 1.0
    assert float(jnp.abs(m1.sh[:, 4:]).max()) == 0.0
    m3 = apply_sh_warmup(model, jnp.int32(30), tc)  # all 16 coeffs
    assert float(m3.sh.min()) == 1.0
    # off by default: identity
    m_off = apply_sh_warmup(model, jnp.int32(0), TrainConfig())
    assert float(m_off.sh.min()) == 1.0


def test_separable_ssim_filter_matches_depthwise_conv():
    """The shift-add separable Gaussian filter must equal the depthwise-conv
    formulation it replaced."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gaussian_splat_tpu.train.loss import _filter2d, _gaussian_window_1d

    a = jax.random.uniform(jax.random.PRNGKey(0), (37, 53, 3))
    w1 = _gaussian_window_1d(11)
    w2 = jnp.asarray(np.outer(w1, w1))
    x = a[None].transpose(0, 3, 1, 2)
    ww = jnp.broadcast_to(w2[None, None], (3, 1, 11, 11))
    y = jax.lax.conv_general_dilated(
        x, ww, (1, 1), "SAME", feature_group_count=3,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0].transpose(1, 2, 0)
    np.testing.assert_allclose(np.asarray(_filter2d(a, w1)), np.asarray(y),
                               atol=1e-6)


def test_adc_checkpoint_and_resume(tmp_path):
    """fit_multiview_adc saves AdcTrainState checkpoints and resume=True
    continues from the saved step instead of restarting (SURVEY §5
    checkpoint/resume; VERDICT r4: training curve with a mid-run resume)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gaussian_splat_tpu.camera import Camera
    from gaussian_splat_tpu.config import RenderConfig, TrainConfig
    from gaussian_splat_tpu.models.gaussians import GaussianModel
    from gaussian_splat_tpu.ops.render import render
    from gaussian_splat_tpu.train.checkpoint import latest_step
    from gaussian_splat_tpu.train.dataset import ViewDataset
    from gaussian_splat_tpu.train.trainer import fit_multiview_adc

    cam = Camera.from_lookat((0, 0, -3), (0, 0, 0), (0, 1, 0), 60.0, 32, 32)
    gt = GaussianModel.random(jax.random.PRNGKey(1), 32, extent=0.8,
                              scale_range=(0.05, 0.2))
    cfg = RenderConfig(backend="jnp_tile")
    img = np.asarray(render(gt, cam, cfg).image)
    ds = ViewDataset.from_views([(cam, img)])

    model = GaussianModel.random(jax.random.PRNGKey(2), 32, extent=0.8,
                                 scale_range=(0.05, 0.2))
    ck = str(tmp_path / "ck")
    tc_half = TrainConfig(num_steps=6, checkpoint_dir=ck, checkpoint_every=3)
    _, h1 = fit_multiview_adc(model, ds, cfg, tc_half, densify_every=4,
                              opacity_reset_every=0, log_every=1)
    assert latest_step(ck) == 6  # saved at (i+1) % 3 == 0 → steps 3 and 6

    tc_full = TrainConfig(num_steps=10, checkpoint_dir=ck, checkpoint_every=3)
    fitted, h2 = fit_multiview_adc(model, ds, cfg, tc_full, densify_every=4,
                                   opacity_reset_every=0, log_every=1,
                                   resume=True)
    # resumed run trains only the remaining 4 steps
    assert len(h2) == 4
    assert latest_step(ck) == 9
    assert np.isfinite(h2[-1])
