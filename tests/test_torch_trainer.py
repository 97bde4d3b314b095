"""The port's inverse-rendering trainer (``polaris_tpu_torch/render/
trainer.py``) against the JAX package's, on the CPU.

* Each optimizer against optax on one 5-step gradient sequence made with
  numpy from a seed (one step's gradients are 1e-6, where torch's stock
  ``RMSprop`` is orders of magnitude off): parameters within rtol 1e-6.
* The port's ``Trainer`` against the JAX ``Trainer`` on cornell 24x24, Adam,
  3 steps: histories within rtol 1e-3; parameters within 1e-3 where the
  first step's JAX gradient exceeds 1% of its field's largest, elsewhere
  within ``2 * steps * lr`` (an Adam step moves a leaf by about ``lr``
  whatever the gradient's size, so a near-zero gradient whose sign differs
  between the frameworks moves it by up to ``2 lr`` a step).
* The two tests of ``tests/test_trainer.py`` on the port, thresholds kept.
* A checkpoint the JAX ``Trainer`` wrote resumes in the port and one the
  port wrote resumes in the JAX package: the next step's loss within rtol
  1e-3 of the writer's own next step.
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FRAME = dict(width=24, height=24, spp=2, num_bounces=2, min_bounces_for_rr=3)
STEPS = 3
LR = 3e-2


def _scene_dict(scene):
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


def _gradient_sequence():
    rng = np.random.default_rng(8)
    return [
        {k: (rng.normal(size=shape) * scale).astype(np.float32) for k, shape in
         (("a", (4, 3)), ("b", (5,)))}
        for scale in (1.0, 1e-6, 1e-3, 10.0, 0.5)
    ]


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizer_matches_optax(name):
    import jax.numpy as jnp
    import optax

    from polaris_tpu_torch.render.trainer import _OPTIMIZERS

    rng = np.random.default_rng(3)
    start = {"a": rng.uniform(0.25, 1.0, (4, 3)).astype(np.float32),
             "b": rng.uniform(0.25, 1.0, 5).astype(np.float32)}
    tx = {"adam": optax.adam, "sgd": optax.sgd, "rmsprop": optax.rmsprop}[name](LR)
    p_jax = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(p_jax)
    p_torch = {k: torch.tensor(v, requires_grad=True) for k, v in start.items()}
    stock = {k: torch.tensor(v, requires_grad=True) for k, v in start.items()}
    opt = _OPTIMIZERS[name](list(p_torch.values()), LR)
    stock_opt = torch.optim.RMSprop(list(stock.values()), lr=LR)
    for g in _gradient_sequence():
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p_jax)
        p_jax = {k: p_jax[k] + updates[k] for k in p_jax}
        for k in p_torch:
            p_torch[k].grad = torch.from_numpy(g[k])
            stock[k].grad = torch.from_numpy(g[k])
        opt.step()
        stock_opt.step()
    for k in p_jax:
        np.testing.assert_allclose(p_torch[k].detach().numpy(), np.asarray(p_jax[k]),
                                   rtol=1e-6, err_msg=k)
    if name == "rmsprop":  # what the port's own RMSprop is for
        assert not np.allclose(stock["a"].detach().numpy(), np.asarray(p_jax["a"]), rtol=1e-2)


def _target(scene, opt, factor=0.55):
    """A target rendered by the JAX package with scaled-down diffuse
    colors (tests/test_trainer.py::_target)."""
    from polaris_tpu.render.grad import DifferentiableRenderer
    from polaris_tpu.render.shade import tonemap_reinhard

    r = DifferentiableRenderer(scene, mode="bvh")
    params = dict(r.params)
    params["mat_reflectance"] = r.params["mat_reflectance"] * factor
    accum = np.asarray(r.render_from_params(opt, params))
    return tonemap_reinhard(np, accum + 1e-6, 1.0 / opt.spp, opt.exposure)


def _params(trainer):
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v).copy()
            for k, v in trainer.renderer.params.items()}


@pytest.fixture(scope="module")
def runs(cornell_scene, tmp_path_factory):
    """Both trainers fit cornell for STEPS Adam steps, each writes a
    checkpoint and takes one more step; then each resumes from the other's
    checkpoint and takes that step again."""
    from polaris_tpu.render.options import RenderOptions as JaxOptions
    from polaris_tpu.render.trainer import TrainConfig as JaxConfig
    from polaris_tpu.render.trainer import Trainer as JaxTrainer
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.trainer import TrainConfig, Trainer

    target = _target(cornell_scene, JaxOptions(**FRAME))
    out = {"target": target}
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("jax", "port")}

    jt = JaxTrainer(cornell_scene, JaxOptions(**FRAME),
                    JaxConfig(learning_rate=LR, num_steps=STEPS, checkpoint_dir=dirs["jax"]),
                    mode="bvh")
    out["jax_grads0"] = {k: np.asarray(v) for k, v in
                         jt.renderer.loss_and_grad(jt.opt, target, jt.camera)[1].items()}
    out["jax_history"] = list(jt.fit(target))
    out["jax_params"] = _params(jt)
    out["jax_next"] = jt.step(target)

    def port_trainer():
        return Trainer(_scene_dict(cornell_scene), RenderOptions(**FRAME),
                       TrainConfig(learning_rate=LR, num_steps=STEPS,
                                   checkpoint_dir=dirs["port"]),
                       mode="bvh", device="cpu")

    pt = port_trainer()
    out["port_history"] = list(pt.fit(target))
    out["port_params"] = _params(pt)
    out["port_next"] = pt.step(target)

    resumed = port_trainer()
    resumed.restore_checkpoint(f"{dirs['jax']}/ckpt_{STEPS:06d}.npz")
    out["port_from_jax_step"] = resumed.step_idx
    out["port_from_jax"] = resumed.step(target)
    jt.restore_checkpoint(f"{dirs['port']}/ckpt_{STEPS:06d}.npz")
    out["jax_from_port_step"] = jt.step_idx
    out["jax_from_port"] = jt.step(target)
    return out


def test_trainer_matches_jax(runs):
    np.testing.assert_allclose(runs["port_history"], runs["jax_history"], rtol=1e-3)
    for k, want in runs["jax_params"].items():
        got = runs["port_params"][k]
        g = np.abs(runs["jax_grads0"][k])
        strong = g > 0.01 * g.max() if g.max() > 0 else np.zeros_like(g, bool)
        np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(got[~strong], want[~strong], rtol=0,
                                   atol=2 * STEPS * LR, err_msg=k)


def test_jax_checkpoint_resumes_in_port(runs):
    assert runs["port_from_jax_step"] == STEPS
    np.testing.assert_allclose(runs["port_from_jax"], runs["jax_next"], rtol=1e-3)


def test_port_checkpoint_resumes_in_jax(runs):
    assert runs["jax_from_port_step"] == STEPS
    np.testing.assert_allclose(runs["jax_from_port"], runs["port_next"], rtol=1e-3)


def test_fit_recovers_texture_and_roughness(textured_scene):
    """tests/test_trainer.py's test on the port: the trainer moves the
    texture atlas and a roughness leaf toward a target rendered with
    perturbed values."""
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.shade import tonemap_reinhard
    from polaris_tpu_torch.render.trainer import TrainConfig, Trainer

    opt = RenderOptions(**FRAME)
    cfg = TrainConfig(learning_rate=4e-2, num_steps=8,
                      trainable=("tex_data", "mat_roughness"), reseed_each_step=False)
    tr = Trainer(_scene_dict(textured_scene), opt, cfg, mode="bvh", device="cpu")
    r = tr.renderer
    tex0 = r.params["tex_data"].detach().clone()
    rough0 = r.params["mat_roughness"].detach().clone()
    rough_row = int((rough0 > 0).to(torch.int8).argmax())  # the roughConductor leaf
    tgt_rough = rough0.clone()
    tgt_rough[rough_row] = 0.6
    accum = r.render_from_params(opt, {"tex_data": tex0 * 0.5, "mat_roughness": tgt_rough})
    target = tonemap_reinhard(accum + 1e-6, 1.0 / opt.spp, opt.exposure).numpy()

    history = tr.fit(target)
    assert history[-1] < history[0] * 0.7, history
    tex1 = r.params["tex_data"].detach()
    moved = (tex1 - tex0).abs() > 1e-6
    assert moved.any(), "trainer never touched the atlas"
    tex_tgt = tex0 * 0.5
    d0 = (tex0[moved] - tex_tgt[moved]).abs().mean()
    d1 = (tex1[moved] - tex_tgt[moved]).abs().mean()
    assert d1 < d0, (d0, d1)
    r1 = float(r.params["mat_roughness"].detach()[rough_row])
    assert abs(r1 - 0.6) < abs(float(rough0[rough_row]) - 0.6), r1


def test_fit_reduces_loss(cornell_scene, tmp_path):
    """tests/test_trainer.py's test on the port: the loss falls, the
    checkpoint restores into a fresh trainer, and training resumes."""
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.shade import tonemap_reinhard
    from polaris_tpu_torch.render.trainer import TrainConfig, Trainer

    opt = RenderOptions(**FRAME)
    cfg = TrainConfig(learning_rate=3e-2, num_steps=6, reseed_each_step=False,
                      checkpoint_dir=str(tmp_path), checkpoint_every=3)
    scene = _scene_dict(cornell_scene)
    tr = Trainer(scene, opt, cfg, mode="bvh", device="cpu")
    dark = tr.renderer.params["mat_reflectance"].detach() * 0.55
    accum = tr.renderer.render_from_params(opt, {"mat_reflectance": dark})
    target = tonemap_reinhard(accum + 1e-6, 1.0 / opt.spp, opt.exposure).numpy()
    history = tr.fit(target)
    assert history[-1] < history[0] * 0.7, history
    tr2 = Trainer(scene, opt, cfg, mode="bvh", device="cpu")
    tr2.restore_checkpoint()
    assert tr2.step_idx == tr.step_idx
    for k in tr.renderer.params:
        assert torch.equal(tr2.renderer.params[k], tr.renderer.params[k]), k
    assert np.isfinite(tr2.step(target))


def test_device_none_needs_a_card(cornell_scene):
    """``device=None`` means the CUDA device: without one the renderers and
    the trainer raise rather than fall back to the CPU."""
    from polaris_tpu_torch.render.grad import DifferentiableRenderer
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.trainer import TrainConfig, Trainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = _scene_dict(cornell_scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DifferentiableRenderer(scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(scene, RenderOptions(**FRAME), TrainConfig())


def test_new_modules_import_neither_jax_nor_optax():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import polaris_tpu_torch.render.grad, polaris_tpu_torch.render.trainer\n"
        "import polaris_tpu_torch.render.denoise\n"
        "from polaris_tpu_torch import DifferentiableRenderer, Trainer, TrainConfig, denoise_accum\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'polaris_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=repo)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_optimize_camera_moves_the_eye_down_its_gradient(cornell_scene):
    """``optimize_camera``: after the parameters, the eye moves by ``-lr``
    times its gradient and the frustum follows (``Camera.update``)."""
    from polaris_tpu_torch.render.options import RenderOptions
    from polaris_tpu_torch.render.trainer import TrainConfig, Trainer

    opt = RenderOptions(**FRAME)
    target = np.full((opt.height, opt.width, 3), 0.3, np.float32)
    cfg = TrainConfig(learning_rate=LR, optimize_camera=True, reseed_each_step=False,
                      trainable=())
    tr = Trainer(_scene_dict(cornell_scene), opt, cfg, mode="bvh", device="cpu")
    eye0 = np.array(tr.camera.position, np.float32)
    frustum0 = np.array(tr.camera.frustum, np.float32)
    g_eye = tr.renderer.loss_and_grad(opt, target, tr.camera)[2]["eye"].numpy()
    tr.step(target)
    assert np.abs(g_eye).max() > 0
    np.testing.assert_array_equal(tr.camera.position, eye0 - np.float32(LR) * g_eye)
    assert not np.array_equal(tr.camera.frustum, frustum0)
