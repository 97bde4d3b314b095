"""Adaptive per-block sampling in the port, on the CPU: the five tests of
``tests/test_adaptive.py`` on ``TorchRenderer(device="cpu", mode="bvh")``,
and the port against the JAX package's ``render_adaptive``.

64x64 is the least frame with four 32x32 blocks (the stop unit). Converged
blocks stop drawing samples; the RNG's absolute sample indices make a block
that stopped at n samples hold exactly the accumulator of a fixed n-sample
render (one partial). Against the JAX package: the same ``spp_map``, and
``accum`` within the tolerance of ``tests/test_parity.py::_compare`` (atol
1e-4, rtol 1e-3; a pixel whose path decision flips on an ulp between the
frameworks is counted, at most 0.5% of the frame). ``tol`` is the midpoint
between two neighbouring block CIs of the JAX run, so no stop decision
rests on rounding.
"""

from dataclasses import fields, replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.render.integrator import (  # noqa: E402
    TILE_LANES,
    TorchRenderer,
    blocked_pixel_order,
)
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402

ATOL, RTOL = 1e-4, 1e-3
MAX_FLIPPED_SHARE = 0.005


@pytest.fixture(scope="module")
def renderer(cornell_scene):
    return TorchRenderer(
        {f.name: getattr(cornell_scene, f.name) for f in fields(cornell_scene)},
        device="cpu", mode="bvh",
    )


def _opt(spp):
    return RenderOptions(width=64, height=64, spp=spp, num_bounces=2, min_bounces_for_rr=3)


def test_adaptive_budget_matches_uniform(renderer):
    """With tol=0 no block ever converges: the adaptive render must equal
    the plain fixed-spp render bit for bit (same per-sample add order)."""
    opt = _opt(4)
    uniform = renderer.render_accum(opt)
    accum, spp_map = renderer.render_adaptive(opt, tol=0.0, chunk=4)
    assert (spp_map == 4).all()
    assert torch.equal(accum, uniform)


def test_adaptive_blocks_stop_and_reproduce(renderer):
    """Blocks that stop early hold EXACTLY the accumulator of a one-partial
    render with that block's sample count, and a noisy scene at a loose
    tolerance actually stops some blocks."""
    opt = _opt(12)
    accum, spp_map = renderer.render_adaptive(opt, tol=0.25, chunk=4, min_spp=4)
    counts = np.unique(spp_map.numpy())
    assert counts.min() >= 4 and counts.max() <= 12
    assert counts.size > 1, "tolerance 0.25 should stop some blocks early"
    for c in counts:
        fixed = renderer.render_accum_offset(replace(opt, spp=int(c)))
        sel = spp_map == int(c)
        assert torch.equal(accum[sel], fixed[sel]), c


def test_adaptive_spp_map_block_structure(renderer):
    """The spp map is constant over each 32x32 block (the stop unit)."""
    _, spp_map = renderer.render_adaptive(_opt(8), tol=0.3, chunk=4, min_spp=4)
    xs, ys, pix, inv = blocked_pixel_order(64, 64)
    lane_spp = spp_map.numpy().reshape(-1)[pix]  # lane order
    blocks = lane_spp.reshape(-1, TILE_LANES)
    assert (blocks == blocks[:, :1]).all()


def test_adaptive_u8_weighting(renderer):
    """Per-pixel sample weights: a block stopped at n samples is tonemapped
    with 1/n, so brightness is unbiased against the uniform image."""
    opt = _opt(8)
    img, spp_map = renderer.render_adaptive_u8(opt, tol=0.2, chunk=4, min_spp=4)
    assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
    assert spp_map.dtype == np.int32 and spp_map.shape == (64, 64)
    ref = (np.clip(renderer.render(opt), 0, 1) * 255 + 0.5).astype(np.uint8)
    # adaptive differs only by estimator noise in stopped blocks; a 1/spp
    # bug would scale whole blocks by 2x
    assert np.abs(img.astype(int) - ref.astype(int)).mean() < 2.0


def test_adaptive_budget_cap_non_multiple(renderer):
    """opt.spp is a hard budget CAP even when it is no multiple of the chunk."""
    opt = _opt(6)
    accum, spp_map = renderer.render_adaptive(opt, tol=0.0, chunk=4)
    assert int(spp_map.max()) == 6
    assert torch.equal(accum, renderer.render_accum_offset(opt))


def test_adaptive_matches_jax(renderer, cornell_scene):
    """8 spp in chunks of 4, checked from 4 spp: ``tol`` between the second
    and third block CI of the JAX package's first chunk, so two blocks stop
    at 4 samples and two run to 8 on both sides."""
    import jax.numpy as jnp

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    kw = dict(width=64, height=64, spp=8, num_bounces=2, min_bounces_for_rr=3)
    jr = TpuRenderer(cornell_scene, mode="bvh")
    jopt = JaxOptions(**kw)
    cam = Camera.from_scene(cornell_scene, 64, 64)
    n, nblocks = 64 * 64, 4
    zeros3, zeros = jnp.zeros((n, 3), jnp.float32), jnp.zeros(n, jnp.float32)
    *_, block_ci = jr._get_adaptive_fn(jopt, 4)(
        jr.geom, jr.params, jnp.asarray(cam.frustum), jnp.asarray(cam.position),
        jnp.uint32(0), jnp.int32(0), jnp.ones(nblocks, bool),
        jnp.full(nblocks, 4.0, jnp.float32), zeros3, zeros, zeros,
    )
    ci = np.sort(np.asarray(block_ci))
    tol = float((ci[1] + ci[2]) / 2)
    want_accum, want_map = jr.render_adaptive(jopt, tol=tol, chunk=4, min_spp=4)
    assert sorted(np.unique(want_map, return_counts=True)[1]) == [2048, 2048]

    accum, spp_map = renderer.render_adaptive(RenderOptions(**kw), tol=tol, chunk=4, min_spp=4)
    np.testing.assert_array_equal(spp_map.numpy(), want_map)
    got = accum.numpy()
    bad = (~np.isclose(got, want_accum, atol=ATOL, rtol=RTOL)).any(axis=-1)
    assert int(bad.sum()) <= int(MAX_FLIPPED_SHARE * bad.size), int(bad.sum())
    assert want_accum.mean() > 1e-3
