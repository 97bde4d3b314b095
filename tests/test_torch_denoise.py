"""The port's à-trous denoiser (``polaris_tpu_torch/render/denoise.py``)
against the JAX package's, on the CPU.

* ``despeckle`` and ``atrous_denoise`` against the JAX functions called
  with ``xp=np`` on the same seeded images: within 1e-5.
* ``denoise_accum`` on sphere 32x32: the guides through K1's plain version
  (``mode="auto"``) against the JAX package's through ``mode="packet"``,
  and the denoised accumulator, both within 1e-4 (the two traversals' hit
  distances differ in the last bits).
* The 1x1 frame: the JAX ``despeckle`` leaves -inf there (its second-
  brightest neighbour is the -inf padding); the port keeps the pixel. The
  test records that deliberate divergence.
* A gradient through the filter against ``jax.grad`` of the JAX filter.
* The guide and filter programs against ``guide_images`` and
  ``filter_accum`` called op by op, at two cameras and two accumulators:
  bit for bit.
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATOL = 1e-5


def _images(shape, seed):
    """A noisy HDR image with fireflies, unit normals and depths."""
    rng = np.random.default_rng(seed)
    h, w = shape
    color = (rng.random((h, w, 3)) ** 3 * 2.0).astype(np.float32)
    color[rng.random((h, w)) < 0.02] *= 200.0
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = rng.random((h, w)).astype(np.float32)
    return color, normal, depth


@pytest.mark.parametrize("shape", [(16, 16), (20, 13), (2, 5)])
def test_despeckle_matches_jax(shape):
    from polaris_tpu.render.denoise import despeckle as jax_despeckle
    from polaris_tpu_torch.render.denoise import despeckle

    color, _, _ = _images(shape, 1)
    color[0, 0] = 400.0  # a corner firefly
    got = despeckle(torch.from_numpy(color)).numpy()
    np.testing.assert_allclose(got, jax_despeckle(np, color), rtol=0, atol=ATOL)


@pytest.mark.parametrize("iterations", [1, 4])
def test_atrous_denoise_matches_jax(iterations):
    from polaris_tpu.render.denoise import atrous_denoise as jax_atrous
    from polaris_tpu_torch.render.denoise import atrous_denoise

    color, normal, depth = _images((24, 19), 2)
    want = jax_atrous(np, color, normal, depth, iterations=iterations)
    got = atrous_denoise(*(torch.from_numpy(a) for a in (color, normal, depth)),
                         iterations=iterations)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * np.abs(want).max())


def test_despeckle_keeps_a_pixel_without_two_neighbours():
    """The deliberate divergence: on a 1x1 frame (and at the ends of a frame
    one pixel wide) the JAX function scales by -inf; the port keeps the
    pixel, and is the JAX function wherever two real neighbours exist."""
    from polaris_tpu.render.denoise import despeckle as jax_despeckle
    from polaris_tpu_torch.render.denoise import despeckle

    one = np.full((1, 1, 3), 0.7, np.float32)
    assert np.isneginf(jax_despeckle(np, one)).all()
    assert torch.equal(despeckle(torch.from_numpy(one)), torch.from_numpy(one))
    row = np.array([[[1.0] * 3, [9.0] * 3, [1.0] * 3, [2.0] * 3]], np.float32)
    want = jax_despeckle(np, row)
    got = despeckle(torch.from_numpy(row)).numpy()
    assert np.isneginf(want[0, [0, -1]]).all()
    np.testing.assert_array_equal(got[0, [0, -1]], row[0, [0, -1]])
    np.testing.assert_array_equal(got[0, 1:-1], want[0, 1:-1])


def test_denoise_accum_matches_jax(sphere_scene):
    from polaris_tpu.render.denoise import denoise_accum as jax_denoise_accum
    from polaris_tpu.render.denoise import render_guides as jax_render_guides
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions
    from polaris_tpu_torch.render.denoise import denoise_accum, render_guides
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    frame = dict(width=32, height=32, spp=2, num_bounces=2, min_bounces_for_rr=3)
    jr = TpuRenderer(sphere_scene, mode="packet")
    accum = np.asarray(jr.render_accum(JaxOptions(**frame)))
    r = TorchRenderer({f.name: getattr(sphere_scene, f.name) for f in fields(sphere_scene)},
                      device="cpu", mode="auto")
    opt = RenderOptions(**frame)

    j_nrm, j_z = jax_render_guides(jr, JaxOptions(**frame))
    nrm, z = render_guides(r, opt)
    np.testing.assert_allclose(nrm.numpy(), j_nrm, rtol=0, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), j_z, rtol=0, atol=1e-4)

    want = jax_denoise_accum(jr, JaxOptions(**frame), accum, frame["spp"], iterations=3)
    got = denoise_accum(r, opt, accum, frame["spp"], iterations=3)
    assert got.shape == (32, 32, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the programs are kept: a second call is the same
    assert torch.equal(denoise_accum(r, opt, accum, frame["spp"], iterations=3), got)


def test_gradient_through_the_filter_matches_jax():
    import jax
    import jax.numpy as jnp

    from polaris_tpu.render.denoise import atrous_denoise as jax_atrous
    from polaris_tpu.render.denoise import despeckle as jax_despeckle
    from polaris_tpu_torch.render.denoise import atrous_denoise, despeckle

    color, normal, depth = _images((16, 16), 3)
    color = np.clip(color, 0.0, 4.0)  # fireflies off: a smooth neighbourhood

    def jax_loss(x):
        return jnp.sum(jax_atrous(jnp, jax_despeckle(jnp, x), normal, depth, iterations=2) ** 2)

    want = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(color)))
    x = torch.tensor(color, requires_grad=True)
    n, d = torch.from_numpy(normal), torch.from_numpy(depth)
    torch.sum(atrous_denoise(despeckle(x), n, d, iterations=2) ** 2).backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_programs_equal_the_reference_functions(sphere_scene):
    """Each call fills the programs' static inputs anew: two cameras, two
    accumulators and two sets of bandwidths give the reference functions'
    results, bit for bit."""
    from polaris_tpu_torch.asset.camera import Camera
    from polaris_tpu_torch.render.denoise import (
        denoise_accum, filter_accum, guide_images, render_guides,
    )
    from polaris_tpu_torch.render.integrator import TorchRenderer
    from polaris_tpu_torch.render.options import RenderOptions

    r = TorchRenderer({f.name: getattr(sphere_scene, f.name) for f in fields(sphere_scene)},
                      device="cpu", mode="auto")
    opt = RenderOptions(width=24, height=16, spp=2, num_bounces=2, min_bounces_for_rr=3)
    moved = Camera.from_scene(r.scene, opt.width, opt.height)
    moved.move("left", 0.3)
    runs = [(None, 2, dict(c_phi=0.4, n_phi=0.25, d_phi=0.05)),
            (moved, 3, dict(c_phi=0.3, n_phi=0.2, d_phi=0.1))]
    outs = []
    for seed, (camera, spp, bw) in enumerate(runs):
        accum = torch.from_numpy(_images((opt.height, opt.width), 10 + seed)[0])
        nrm, z = render_guides(r, opt, camera)
        want_nrm, want_z = guide_images(r, *r._camera_tensors(opt, camera), opt.width,
                                        opt.height)
        assert torch.equal(nrm, want_nrm) and torch.equal(z, want_z)
        got = denoise_accum(r, opt, accum, spp, camera, iterations=2, **bw)
        # the program reads the bandwidths and the count from 0-d tensors
        want = filter_accum(accum, want_nrm, want_z, torch.tensor(float(spp)), iterations=2,
                            fireflies=True, **{k: torch.tensor(v) for k, v in bw.items()})
        assert torch.equal(got, want)
        outs.append((nrm, got))
    assert not torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[0][1], outs[1][1])
