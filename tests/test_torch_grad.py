"""The port's differentiable path (``polaris_tpu_torch/render/grad.py``)
against the JAX package's, on the CPU.

* ``loss_and_grad`` against ``DifferentiableRenderer(mode="bvh")`` on
  cornell, sphere and the textured scene of ``tests/conftest.py`` at 24x24,
  2 spp, 2 bounces, zero target: the loss within rtol 1e-5; each gradient
  field within 1e-3 of the JAX field's largest |gradient| (the two differ by
  at most 1.3e-4 of it, cornell's ``mat_roughness``); the camera's ``eye``
  and ``frustum`` within rtol 1e-3, atol 1e-6; the same keys and shapes,
  zeros where no gradient arrives.
* The finite-difference gates of ``tests/test_grad.py`` on the port
  (reflectance; a texel; roughness and IOR at one bounce; the eye and the
  frustum over a flat floor), relative error under 0.08.
* The byte-texture warning, ``render_from_params``' in-place rule, and the
  compiled step (called directly on the CPU) against the eager function,
  bit for bit.
* The port's step against ``tests/fixtures/torch_golden_grad_cornell_24.npz``,
  which ``chip_smoke.py`` holds the card against (loss rtol 1e-4, each field
  within 1e-3 of its largest |gradient|). ``python tests/test_torch_grad.py
  --write-fixture`` regenerates it from ``mode="packet"``.
"""

import logging
import os
import sys
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_golden_grad_cornell_24.npz")
FRAME = dict(width=24, height=24, spp=2, num_bounces=2, min_bounces_for_rr=3)
FD_TOL = 0.08


def _scene_dict(scene):
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


def _opt(**kw):
    from polaris_tpu_torch.render.options import RenderOptions

    return RenderOptions(**{**FRAME, **kw})


def _renderer(scene, mode="bvh"):
    from polaris_tpu_torch.render.grad import DifferentiableRenderer

    return DifferentiableRenderer(_scene_dict(scene), device="cpu", mode=mode)


def _zero_target(opt):
    return np.zeros((opt.height, opt.width, 3), np.float32)


def _loss(r, opt, params, target, camera=None):
    """The loss of a forward render with ``params``, as tests/test_grad.py
    forms it."""
    from polaris_tpu_torch.render.shade import tonemap_reinhard

    accum = r.render_from_params(opt, params, camera)
    img = tonemap_reinhard(accum + 1e-6, 1.0 / opt.spp, opt.exposure)
    return float(torch.mean((img - torch.from_numpy(target)) ** 2))


def _fd(r, opt, field, index, eps, target):
    base = r.params[field].detach().clone()
    plus, minus = base.clone(), base.clone()
    plus[index] += eps
    minus[index] -= eps
    return (
        _loss(r, opt, {field: plus}, target) - _loss(r, opt, {field: minus}, target)
    ) / (2 * eps)


@pytest.fixture(scope="module")
def scenes(cornell_scene, sphere_scene, textured_scene):
    return {"cornell": cornell_scene, "sphere": sphere_scene, "textured": textured_scene}


@pytest.mark.parametrize("name", ["cornell", "sphere", "textured"])
def test_loss_and_grad_matches_jax(scenes, name):
    from polaris_tpu.render.grad import DifferentiableRenderer as JaxRenderer
    from polaris_tpu.render.options import RenderOptions as JaxOptions

    opt = _opt()
    target = _zero_target(opt)
    j_loss, j_grads, j_cam = JaxRenderer(scenes[name], mode="bvh").loss_and_grad(
        JaxOptions(**FRAME), target
    )
    loss, grads, cam = _renderer(scenes[name]).loss_and_grad(opt, target)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert sorted(grads) == sorted(j_grads) and sorted(cam) == sorted(j_cam)
    for k, want in j_grads.items():
        want = np.asarray(want)
        got = grads[k]
        assert got.device.type == "cpu" and tuple(got.shape) == want.shape, k
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max(), err_msg=k
        )
    for k, want in j_cam.items():
        assert tuple(cam[k].shape) == np.asarray(want).shape, k
        np.testing.assert_allclose(cam[k].numpy(), np.asarray(want), rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_reflectance_gradient_fd(scenes):
    opt = _opt()
    target = _zero_target(opt)
    r = _renderer(scenes["cornell"])
    _, g, _ = r.loss_and_grad(opt, target)
    m = int(g["mat_reflectance"].abs().sum(dim=1).argmax())
    fd = _fd(r, opt, "mat_reflectance", (m, 0), 2e-3, target)
    ad = float(g["mat_reflectance"][m, 0])
    assert fd != 0.0
    assert abs(fd - ad) / (abs(fd) + 1e-8) < FD_TOL, (fd, ad)


def test_texture_atlas_gradient_fd(scenes):
    opt = _opt()
    target = _zero_target(opt)
    r = _renderer(scenes["textured"])
    _, g, _ = r.loss_and_grad(opt, target)
    gtex = g["tex_data"]
    assert torch.isfinite(gtex).all() and gtex.abs().max() > 0
    i = int(gtex.abs().argmax())
    fd = _fd(r, opt, "tex_data", i, 2e-3, target)
    ad = float(gtex[i])
    assert fd != 0.0
    assert abs(fd - ad) / (abs(fd) + 1e-8) < FD_TOL, (fd, ad)


def test_roughness_and_ior_leaf_gradient_fd(scenes):
    """One bounce keeps the roughness dependence in the continuous NEE
    terms, where autodiff (traversal carries no gradient) and finite
    differences agree."""
    opt = _opt(num_bounces=1)
    target = _zero_target(opt)
    r = _renderer(scenes["textured"])
    _, g, _ = r.loss_and_grad(opt, target)
    row = int(g["mat_roughness"].abs().argmax())
    for field, eps in (("mat_roughness", 2e-3), ("mat_int_ior", 4e-3)):
        ad = float(g[field][row])
        assert ad != 0.0, field
        fd = _fd(r, opt, field, row, eps, target)
        assert abs(fd - ad) / (abs(fd) + 1e-8) < FD_TOL, (field, fd, ad)


@pytest.fixture(scope="module")
def flat_scene(tmp_path_factory):
    """A uniform gray floor seen dead-on from above, lit from behind the
    camera: the frozen-t camera derivative is exact for lateral eye moves
    and image-space pans (tests/test_grad.py::flat_scene)."""
    from polaris_tpu_torch.asset.compiler.compiler import compile_scene
    from polaris_tpu_torch.asset.wavefront import read_scene

    d = tmp_path_factory.mktemp("flat")
    (d / "f.mtl").write_text(
        "newmtl gray\nmat_expr diffuse(reflectance: {0.6, 0.55, 0.5})\n\n"
        "newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 14)\n\n"
    )
    (d / "f.obj").write_text(
        "mtllib f.mtl\n"
        "camera_fov 45\ncamera_eye 0.1 1.5 0.05\ncamera_look 0.1 0 0.05\n"
        "camera_up 0 0 -1\n"
        "v -3 0 -3\nv -3 0 3\nv 3 0 3\nv 3 0 -3\n"
        "usemtl gray\nf 1 2 3 4\n"
        "v -0.6 2.6 -0.6\nv 0.6 2.6 -0.6\nv 0.6 2.6 0.6\nv -0.6 2.6 0.6\n"
        "usemtl lamp\nf 5 6 7 8\n"
    )
    return compile_scene(read_scene(str(d / "f.obj")))


def test_camera_eye_and_frustum_gradient_fd(flat_scene):
    from polaris_tpu_torch.asset.camera import Camera

    opt = _opt(num_bounces=1)
    target = _zero_target(opt)
    r = _renderer(flat_scene)
    cam = Camera.from_scene(flat_scene, opt.width, opt.height)
    _, _, g_cam = r.loss_and_grad(opt, target, camera=cam)
    assert torch.isfinite(g_cam["eye"]).all() and torch.isfinite(g_cam["frustum"]).all()

    def loss_with(position=None, frustum=None):
        c = cam.clone()
        if position is not None:
            c.position = np.asarray(position, np.float32)
        if frustum is not None:
            c.frustum = np.asarray(frustum, np.float32)
        return _loss(r, opt, {}, target, c)

    eps = 2e-3
    for axis in (0, 2):  # lateral axes (the floor is y-up)
        p, m = np.array(cam.position, np.float32), np.array(cam.position, np.float32)
        p[axis] += eps
        m[axis] -= eps
        fd = (loss_with(position=p) - loss_with(position=m)) / (2 * eps)
        ad = float(g_cam["eye"][axis])
        assert fd != 0.0
        assert abs(fd - ad) / (abs(fd) + 1e-8) < FD_TOL, (axis, fd, ad)
    fr = np.array(cam.frustum, np.float32)
    fp, fm = fr.copy(), fr.copy()
    fp[:, 0] += eps  # a uniform x-shear of the corner rays: an image-space pan
    fm[:, 0] -= eps
    fd = (loss_with(frustum=fp) - loss_with(frustum=fm)) / (2 * eps)
    ad = float(g_cam["frustum"][:, 0].sum())
    assert fd != 0.0
    assert abs(fd - ad) / (abs(fd) + 1e-8) < FD_TOL, (fd, ad)


def test_byte_textures_warn_and_get_zero_texel_gradients(scenes):
    scene = replace(scenes["textured"])
    scene.tex_store = np.ones_like(np.asarray(scene.tex_store))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("polaris.grad")
    log.addHandler(handler)
    try:
        _renderer(scene)
        _renderer(scenes["textured"])
    finally:
        log.removeHandler(handler)
    assert len(records) == 1 and "byte-stored textures" in records[0].getMessage()


def test_render_from_params_keeps_storage_and_restores_values(scenes):
    opt = _opt()
    r = _renderer(scenes["cornell"])
    before = {k: (v.data_ptr(), v.detach().clone()) for k, v in r.S.items() if torch.is_tensor(v)}
    base = r.render_accum(opt)
    dark = r.params["mat_reflectance"].detach() * 0.5
    got = r.render_from_params(opt, {"mat_reflectance": dark.numpy()})
    for k, (ptr, val) in before.items():
        assert r.S[k].data_ptr() == ptr and torch.equal(r.S[k], val), k
    assert r.params["mat_reflectance"] is r.S["mat_reflectance"]
    assert r.params["mat_reflectance"].requires_grad
    assert not torch.equal(got, base)
    with torch.no_grad():
        r.params["mat_reflectance"].copy_(dark)
    assert torch.equal(got, r.render_accum(opt))


@pytest.mark.parametrize("mode", ["bvh", "auto"])
def test_compiled_step_equals_eager_bit_for_bit(scenes, mode):
    from polaris_tpu_torch.render.grad import loss_and_grad_eager

    opt = _opt(seed=3)
    target = np.full((opt.height, opt.width, 3), 0.25, np.float32)
    r = _renderer(scenes["textured"], mode)
    loss, grads, cam = r.loss_and_grad(opt, target)
    e_loss, e_grads, e_cam = loss_and_grad_eager(r, opt, target)
    assert loss == e_loss
    for k in grads:
        assert torch.equal(grads[k], e_grads[k]), k
    for k in cam:
        assert torch.equal(cam[k], e_cam[k]), k
    assert r.loss_only(opt, target) == loss
    # the step's buffers are reused: the dict a call returned is its own
    again = r.loss_and_grad(replace(opt, seed=4), target)[1]
    assert torch.equal(grads["tex_data"], e_grads["tex_data"])
    assert not torch.equal(again["tex_data"], grads["tex_data"])


def test_step_matches_packet_fixture(scenes):
    fx = np.load(FIXTURE)
    opt = _opt()
    assert {k: int(fx[k]) for k in FRAME} == FRAME
    loss, grads, cam = _renderer(scenes["cornell"], "auto").loss_and_grad(opt, _zero_target(opt))
    np.testing.assert_allclose(loss, float(fx["loss"]), rtol=1e-4)
    for k, got in {**grads, **cam}.items():
        want = fx[f"g.{k}"]
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max(), err_msg=k
        )


def _write_fixture():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.grad import DifferentiableRenderer
    from polaris_tpu.render.options import RenderOptions

    scene = compile_scene(read_scene(os.path.join(REPO, "scenes", "cornell.obj")))
    opt = RenderOptions(**FRAME)
    loss, grads, cam = DifferentiableRenderer(scene, mode="packet").loss_and_grad(
        opt, np.zeros((opt.height, opt.width, 3), np.float32)
    )
    out = {f"g.{k}": np.asarray(v) for k, v in {**grads, **cam}.items()}
    np.savez_compressed(
        FIXTURE, loss=np.float32(loss), **out, **{k: np.int64(v) for k, v in FRAME.items()}
    )
    print(f"wrote {FIXTURE}: loss {loss:.6f}, {len(out)} gradient fields")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        sys.path.insert(0, REPO)
        _write_fixture()
    else:
        sys.exit("usage: python tests/test_torch_grad.py --write-fixture")
