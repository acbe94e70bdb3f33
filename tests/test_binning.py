"""Tile-binning invariants: rect coverage, depth ordering within segments,
chunk alignment, overflow accounting."""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import PAIR_ALIGN, RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.binning import bin_gaussians, tile_rects
from gaussian_splat_tpu.ops.projection import project_gaussians


def _scene(n=200, seed=0, width=128, height=96):
    cam = Camera.from_lookat(
        (0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height
    )
    model = GaussianModel.random(
        jax.random.PRNGKey(seed), n, sh_degree=0, extent=1.2,
        scale_range=(0.02, 0.12),
    )
    proj = project_gaussians(model.means, model.quats, model.scales, cam)
    return cam, model, proj


CFG = RenderConfig()


def test_rect_contains_extent():
    cam, model, proj = _scene()
    tx0, ty0, w, h, _ = tile_rects(
        proj.means2d, proj.radii, proj.valid, cam.width, cam.height, CFG
    )
    tw, th = CFG.tile_width, CFG.tile_height
    mx = np.asarray(proj.means2d[:, 0])
    my = np.asarray(proj.means2d[:, 1])
    r = np.asarray(proj.radii, float)
    valid = np.asarray(proj.valid)
    tx0, ty0, w, h = map(np.asarray, (tx0, ty0, w, h))
    for i in np.nonzero(valid)[0]:
        # every on-screen pixel center within the radius box is inside the rect
        x_lo = max(int(np.ceil(mx[i] - r[i] - 0.5)), 0)
        x_hi = min(int(np.floor(mx[i] + r[i] - 0.5)), cam.width - 1)
        if x_lo <= x_hi and w[i] > 0:
            assert tx0[i] * tw <= x_lo and (tx0[i] + w[i]) * tw > x_hi
    assert (w[~valid] == 0).all()


def test_segments_are_depth_ordered_and_contiguous():
    cam, model, proj = _scene(400, seed=1)
    res = bin_gaussians(proj, cam.width, cam.height, CFG)
    num_tiles = CFG.num_tiles(cam.width, cam.height)
    offs = np.asarray(res.tile_offsets)
    counts = np.asarray(res.tile_counts)
    gauss = np.asarray(res.pair_gauss)
    tile = np.asarray(res.pair_tile)
    depths_sorted = np.asarray(proj.depths[res.order])

    assert res.overflow == 0
    # unaligned contract: segments tile the sorted pair list contiguously
    assert offs[0] == 0
    np.testing.assert_array_equal(offs[1:], offs[:-1] + counts[:-1])
    # pair array is padded to a PAIR_ALIGN multiple with sentinels
    assert len(tile) % PAIR_ALIGN == 0
    total = offs[-1] + counts[-1]
    assert (tile[total:] == num_tiles).all()

    total_checked = 0
    for t in range(num_tiles):
        seg = gauss[offs[t] : offs[t] + counts[t]]
        seg_tiles = tile[offs[t] : offs[t] + counts[t]]
        assert (seg_tiles == t).all()
        d = depths_sorted[seg]
        # pair_gauss indexes depth-sorted arrays → indices ascend per segment
        assert (np.diff(seg) > 0).all() if len(seg) > 1 else True
        assert (np.diff(d) >= 0).all()
        total_checked += counts[t]
    assert total_checked == int(res.num_pairs)


def test_pairs_match_bruteforce_overlap():
    cam, model, proj = _scene(100, seed=2)
    res = bin_gaussians(proj, cam.width, cam.height, CFG)
    num_tiles = CFG.num_tiles(cam.width, cam.height)
    tx_n = CFG.tiles_x(cam.width)

    # brute-force: gaussian g overlaps tile t iff t is inside g's effective
    # (two-tier) rect
    from gaussian_splat_tpu.ops.binning import effective_rects

    tx0, ty0, w, h, _, _, _, _ = effective_rects(
        proj.means2d[res.order],
        proj.radii[res.order],
        proj.valid[res.order],
        cam.width,
        cam.height,
        CFG,
        extents=proj.extents[res.order],
    )
    expected = set()
    tx0, ty0, w, h = map(np.asarray, (tx0, ty0, w, h))
    for g in range(100):
        for yy in range(ty0[g], ty0[g] + h[g]):
            for xx in range(tx0[g], tx0[g] + w[g]):
                expected.add((g, yy * tx_n + xx))

    got = set()
    tile = np.asarray(res.pair_tile)
    gauss = np.asarray(res.pair_gauss)
    for p in range(len(tile)):
        if tile[p] < num_tiles:
            got.add((int(gauss[p]), int(tile[p])))
    assert got == expected


def test_overflow_accounting():
    # big splats so actual pairs exceed the budget floor (4096)
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 256, 256)
    model = GaussianModel.random(
        jax.random.PRNGKey(3), 3000, sh_degree=0, extent=1.0,
        scale_range=(0.1, 0.3),
    )
    proj = project_gaussians(model.means, model.quats, model.scales, cam)
    tight = RenderConfig(pairs_per_gaussian=0.5)
    res = bin_gaussians(proj, cam.width, cam.height, tight)
    assert int(res.num_pairs) > tight.pair_budget(3000)  # scene big enough
    assert int(res.overflow) > 0
    kept = int(jnp.sum(res.tile_counts))
    # rank-deterministic truncation: whole farthest gaussians drop, so kept
    # fills the budget up to (at most) one partial gaussian short of it
    assert kept <= tight.pair_budget(3000)
    assert kept + int(res.overflow) == int(res.num_pairs)
    # rank_starts boundaries are exact
    assert int(res.rank_starts[-1]) == kept


def test_rect_clamp_for_huge_gaussian():
    cam = Camera.from_lookat((0, 0, -1.2), (0, 0, 0), (0, 1, 0), 60.0, 256, 256)
    model = GaussianModel.create(
        means=[[0.0, 0.0, 0.0]],
        quats=[[1.0, 0.0, 0.0, 0.0]],
        log_scales=[[np.log(1.0)] * 3],  # huge on screen
        opacity_logits=[2.0],
        sh=[[[1.0, 1.0, 1.0]]],
    )
    proj = project_gaussians(model.means, model.quats, model.scales, cam)
    res = bin_gaussians(proj, cam.width, cam.height, CFG)
    assert int(res.clamped_rects) == 1
    assert int(res.num_pairs) <= CFG.max_tiles_per_gaussian


def test_binning_jits():
    cam, model, proj = _scene(64, seed=4)
    fn = jax.jit(
        lambda p: bin_gaussians(p, cam.width, cam.height, CFG).num_pairs
    )
    a = fn(proj)
    b = bin_gaussians(proj, cam.width, cam.height, CFG).num_pairs
    assert int(a) == int(b)


def test_shrink_to_cap_never_exceeds_cap():
    """Thin rects (edge-clipped wide splats) must respect the area cap: the
    floor-and-bump in _shrink_to_cap used to let a 64x1 rect shrink to 32x1
    with cap 16, desynchronizing rank_starts from the emitted pair count
    (round-1 advisor finding)."""
    from gaussian_splat_tpu.ops.binning import _shrink_to_cap

    rs = np.random.RandomState(0)
    m = 500
    w = rs.randint(1, 80, m)
    h = rs.randint(1, 80, m)
    # include the exact pathological shapes
    w[:4] = [64, 1, 70, 17]
    h[:4] = [1, 64, 2, 1]
    tx0 = np.zeros(m, np.int32)
    ty0 = np.zeros(m, np.int32)
    mx = (tx0 + w / 2.0) * 16.0
    my = (ty0 + h / 2.0) * 16.0
    for cap in (4, 16, 64):
        _, _, w_c, h_c, _ = _shrink_to_cap(
            jnp.asarray(tx0), jnp.asarray(ty0), jnp.asarray(w), jnp.asarray(h),
            cap, jnp.asarray(mx), jnp.asarray(my), 16, 16, 1000, 1000,
        )
        area = np.asarray(w_c) * np.asarray(h_c)
        assert area.max() <= cap, (cap, area.max())
        assert area.min() >= 1


def test_rank_starts_match_emitted_pairs_thin_rects():
    """End-to-end: an edge-clipped anisotropic splat (thin wide rect) followed
    by normal splats — rank_starts must equal the per-rank emitted pair counts
    exactly, or every later gaussian's VJP segment shifts."""
    width, height = 256, 64
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    n = 12
    rs = np.random.RandomState(3)
    means = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    log_scales = np.full((n, 3), np.log(0.05), np.float32)
    # splat 0: extremely anisotropic, centered just above the top edge so the
    # on-screen rect is a thin wide strip
    means[0] = [0.0, -1.36, 0.0]
    log_scales[0] = [np.log(2.0), np.log(0.004), np.log(0.004)]
    model = GaussianModel.create(
        means=means,
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        log_scales=log_scales,
        opacity_logits=np.full((n,), 2.0),
        sh=rs.uniform(0.0, 1.0, (n, 1, 3)),
    )
    cfg = RenderConfig(small_tiles_per_gaussian=8, max_tiles_per_gaussian=16)
    proj = project_gaussians(model.means, model.quats, model.scales, cam)
    assert bool(proj.valid[0]), "edge splat must survive culling for this test"
    b = bin_gaussians(proj, width, height, cfg)
    num_tiles = cfg.num_tiles(width, height)
    valid_pair = np.asarray(b.pair_tile) < num_tiles
    ranks = np.asarray(b.pair_gauss)[valid_pair]
    counts = np.bincount(ranks, minlength=n)
    rank_starts = np.asarray(b.rank_starts)
    claimed = rank_starts[1:] - rank_starts[:-1]
    np.testing.assert_array_equal(counts, claimed)


# ---------------------------------------------------------------------------
# Round-4: exact per-cell σ-bound tile test (output-identical pair culling)
# ---------------------------------------------------------------------------


def test_sigma_tile_test_kills_pairs_without_changing_output():
    """Enabling the σ-bound cell test must cut pairs on a big-splat scene and
    leave the rendered image EXACTLY unchanged (killed pairs are provably
    outside the support ellipse, so their α is identically 0)."""
    from gaussian_splat_tpu.ops.tile_raster import render_tiled

    cam, model, proj = _scene(300, seed=2, width=256, height=192)
    opac = model.opacities
    colors = jnp.full((300, 3), 0.5)

    res_plain = bin_gaussians(proj, cam.width, cam.height, CFG)
    res_test = bin_gaussians(
        proj, cam.width, cam.height, CFG, opacities=opac
    )
    assert int(res_test.num_pairs) < int(res_plain.num_pairs)

    # render_tiled with opacities wires the test internally; compare against
    # a manual composite over the UNtested binning by zeroing the test path:
    img_with, t_with, _ = render_tiled(
        proj, colors, opac, cam.width, cam.height, CFG
    )
    # reference oracle: all pairs, no binning at all
    from gaussian_splat_tpu.ops.reference import render_reference

    img_ref, t_ref, _ = render_reference(
        proj.means2d, proj.conics, colors, opac, proj.depths, proj.valid,
        cam.width, cam.height, CFG,
    )
    np.testing.assert_allclose(
        np.asarray(img_with), np.asarray(img_ref), atol=1e-5, rtol=1e-4
    )


def test_sigma_tile_test_partition_invariant():
    """Per-band survivor counts must sum to the single-chip total: the cell
    test depends only on (splat, GLOBAL tile), so banding cannot change it."""
    cam, model, proj = _scene(400, seed=3, width=128, height=128)
    opac = model.opacities
    full = bin_gaussians(proj, cam.width, cam.height, CFG, opacities=opac)
    ty_n = CFG.tiles_y(cam.height)
    assert ty_n % 4 == 0
    band_rows = ty_n // 4
    total_banded = 0
    for b in range(4):
        res = bin_gaussians(
            proj, cam.width, band_rows * CFG.tile_height, CFG,
            opacities=opac,
            tile_row0=jnp.int32(b * band_rows), total_tiles_y=ty_n,
        )
        total_banded += int(res.num_pairs)
    assert total_banded == int(full.num_pairs)
