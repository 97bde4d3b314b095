"""The integrator's opt-in modes on the CPU: ``TorchRenderer(compact=True)``,
``(sort_rays=True)`` and ``(batch_samples=True)``.

* Each equals the default sequential loop bit for bit (f32 accumulator and
  u8 image), on cornell and sphere, through the compiled driver and through
  the eager reference (``render_blocked_eager``): the RNG keys every draw by
  pixel and sample, so a lane's path does not depend on where it sits, and
  the partials add in sample order. The frame has more samples than one
  launch takes, so ``render_accum`` / ``render_u8`` chunk it (for
  ``batch_samples``: one batch of lanes a chunk).
* Each matches the JAX ``TpuRenderer(mode="bvh", <the same flag>)`` at the
  tolerance of ``tests/test_parity.py::_compare`` (atol 1e-4, rtol 1e-3),
  with at most 0.5% of the pixels off by more, as in
  ``tests/test_torch_compiled.py`` (a Russian-roulette or BxDF decision that
  flips on an ulp between the two frameworks).
* ``compact`` also reaches adaptive sampling and row bands; ``regen`` is
  silently off with any of the three, as in the JAX package
  (``tests/test_regen.py:86-88``).
* The permutation helpers equal the JAX ones on seeded masks and keys.

All three flags together equal the sequential loop too. The JAX package's
``compact`` with ``batch_samples`` keys a compacted lane's draws by its own
pixel but by the sample of the lane it moved to (its ``sample_idx`` is not
permuted, ``polaris_tpu/render/integrator.py:262-293``); the port permutes
it with the pixel, so its image is the sequential loop's.
"""

import os
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.render import integrator as I  # noqa: E402
from polaris_tpu_torch.render.integrator import TorchRenderer, render_blocked_eager  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_LAUNCH = 2
FRAME = dict(width=32, height=32, spp=PER_LAUNCH + 1, num_bounces=2, min_bounces_for_rr=1)
FLAGS = ["compact", "sort_rays", "batch_samples"]
SCENES = ["cornell", "sphere"]
ATOL, RTOL = 1e-4, 1e-3
MAX_FLIPPED_SHARE = 0.005


@pytest.fixture(scope="module")
def scenes():
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    return {
        name: compile_scene(read_scene(os.path.join(REPO, "scenes", f"{name}.obj")))
        for name in SCENES
    }


def _renderer(scene, **kw):
    r = TorchRenderer(
        {f.name: getattr(scene, f.name) for f in fields(scene)}, device="cpu", **kw
    )
    r.spp_per_launch = PER_LAUNCH
    return r


@pytest.fixture(scope="module")
def default(scenes):
    """The default sequential loop's accumulator and u8 image per scene."""
    opt = RenderOptions(**FRAME)
    out = {}
    for name, scene in scenes.items():
        r = _renderer(scene)
        out[name] = (r.render_accum(opt).numpy(), r.render_u8(opt))
    return out


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("name", SCENES)
def test_mode_equals_the_sequential_loop(scenes, default, name, flag):
    opt = RenderOptions(**FRAME)
    r = _renderer(scenes[name], **{flag: True})
    accum, u8 = default[name]
    np.testing.assert_array_equal(r.render_accum(opt).numpy(), accum)
    np.testing.assert_array_equal(r.render_u8(opt), u8)
    eager, _ = render_blocked_eager(r, opt)
    np.testing.assert_array_equal(r.finalize(eager, opt).numpy(), accum)
    assert accum.mean() > 1e-3


def test_all_modes_together_equal_the_sequential_loop(scenes, default):
    opt = RenderOptions(**FRAME)
    r = _renderer(scenes["cornell"], compact=True, sort_rays=True, batch_samples=True)
    np.testing.assert_array_equal(r.render_accum(opt).numpy(), default["cornell"][0])


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("name", SCENES)
def test_mode_matches_jax(scenes, name, flag):
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    ref = TpuRenderer(scenes[name], mode="bvh", **{flag: True})
    ref.spp_per_launch = PER_LAUNCH
    want = np.asarray(ref.render_accum(JaxOptions(**FRAME)))
    got = _renderer(scenes[name], **{flag: True}).render_accum(RenderOptions(**FRAME)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = (~np.isclose(got, want, atol=ATOL, rtol=RTOL)).any(axis=-1)
    assert int(bad.sum()) <= int(MAX_FLIPPED_SHARE * bad.size), (
        int(bad.sum()), float(np.abs(got - want).max())
    )


@pytest.mark.parametrize("flag", FLAGS)
def test_regen_is_silently_off(scenes, default, flag):
    opt = RenderOptions(**FRAME)
    r = _renderer(scenes["cornell"], regen=True, **{flag: True})
    assert not r.regen
    np.testing.assert_array_equal(r.render_accum(opt).numpy(), default["cornell"][0])


def test_compact_reaches_adaptive_sampling_and_bands(scenes):
    opt = RenderOptions(**FRAME)
    base, compact = _renderer(scenes["cornell"]), _renderer(scenes["cornell"], compact=True)
    (a0, m0), (a1, m1) = (r.render_adaptive(opt, tol=0.3, chunk=1) for r in (base, compact))
    np.testing.assert_array_equal(a1.numpy(), a0.numpy())
    np.testing.assert_array_equal(m1.numpy(), m0.numpy())
    b0, b1 = (r.render_band_accum(opt, 8, 16, sample_offset=1) for r in (base, compact))
    np.testing.assert_array_equal(b1.numpy(), b0.numpy())


@pytest.mark.parametrize("n", [1000, 4096])
def test_permutation_helpers_equal_the_jax_ones(n):
    import jax.numpy as jnp

    from polaris_tpu.render import integrator as J

    g = np.random.default_rng(n)
    mask = g.uniform(size=n) < 0.3
    d = g.normal(size=(n, 3)).astype(np.float32)
    pos = I._compact_pos(torch.from_numpy(mask))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(J._compact_pos(jnp.asarray(mask))))
    np.testing.assert_array_equal(
        I._inv_perm(pos).numpy(), np.asarray(J._inv_perm(jnp.asarray(pos.numpy())))
    )
    key = I._octant_key(torch.from_numpy(d), torch.from_numpy(mask))
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(J._octant_key(jnp.asarray(d), jnp.asarray(mask)))
    )
    np.testing.assert_array_equal(
        I._bucket_positions(key, 9).numpy(),
        np.asarray(J._bucket_positions(jnp.asarray(key.numpy(), jnp.int32), 9)),
    )
    assert sorted(pos.tolist()) == list(range(n))
