"""The port's BVH traversal against the JAX package's, on the CPU.

``polaris_tpu_torch.ops.intersect.intersect_bvh`` is the plain PyTorch
binary traversal: with ``leaf="det2"`` the plain version of the CUDA
traversal kernel (``csrc/intersect.cu``; the kernel itself only runs on a
card, where ``chip_smoke.py`` holds it against that plain version), with its
default quotient-form leaf test the port's ``mode="bvh"``. Here the
quotient form is held against three traversals of the JAX package on the same
seeded rays (tests/test_torch_leaf_tests.py holds the det²-scaled and the
Havel–Herout form against the Pallas kernel, with a tighter bound):

  * ``ops.intersect.intersect_bvh``       per-lane stack, one ``while_loop``
  * ``ops.intersect_packet.intersect_packet``  shared stack per 64-ray tile
  * ``ops.intersect_pallas.intersect_pallas``  the TPU kernel the CUDA kernel
    replaces, in Pallas interpret mode: one closest-hit and one any-hit call
    on one ``BLOCK_RAYS`` batch

The port's own XLA twins, ``mode="packet"`` (``ops/intersect_packet.py``)
and ``mode="brute"`` (``intersect_brute``), are held against the JAX
``intersect_packet`` and ``intersect_brute`` on the same rays with the same
tolerances.

Tolerances, on lanes where both sides report the same triangle: ``t`` within
``rtol=1e-5, atol=1e-6``; ``u, v`` within ``atol=1e-4``. A barycentric is a
quotient of dot products that cancel: its rounding error scales with
``|o - v0| * |d x e2| / |det|`` (hundreds of ulps for a small triangle seen
from afar), not with its own size, and XLA contracts multiply-add pairs into
FMAs where PyTorch rounds each product. The count of lanes outside the tight
``rtol=1e-5, atol=1e-6`` window is printed. The traversals visit nodes in
different orders and the Pallas kernel uses another algebraic form of the triangle
test, so on an exact tie (a ray through a shared edge) two of them may keep
different triangles, and within one ulp of an edge or of ``maxt`` one may
hit where the other misses. Such lanes are COUNTED: at most ``MAX_TIE_SHARE``
of the batch, and a lane that reports another triangle must report the same
distance.
"""

import os
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polaris_tpu.asset.camera import Camera  # noqa: E402
from polaris_tpu.ops import intersect as jix  # noqa: E402
from polaris_tpu.ops import rng as jrng  # noqa: E402
from polaris_tpu.ops.intersect_packet import intersect_packet  # noqa: E402
from polaris_tpu.render.raygen import gen_rays  # noqa: E402
from polaris_tpu_torch.ops import intersect as tix  # noqa: E402
from polaris_tpu_torch.ops import intersect_cuda  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402

FLT_MAX = np.float32(3.4028235e38)
RTOL, ATOL = 1e-5, 1e-6  # t
UV_ATOL = 1e-4  # u, v (see the module docstring)
MAX_TIE_SHARE = 2e-3  # lanes that may differ in mask / tri / inst

SCENES = ["cornell", "sphere", "instanced"]


def _primary_rays(scene, width, height, seed=0):
    """Camera rays of one sample, through the JAX package's own raygen
    evaluated with NumPy."""
    cam = Camera.from_scene(scene, width, height)
    n = width * height
    pix = np.arange(n, dtype=np.uint32)
    U = jrng.make_uniform(jrng.np_uniform, seed, pix, 0, 0)
    xs = (pix % width).astype(np.int32)
    ys = (pix // width).astype(np.int32)
    o, d = gen_rays(
        np, np.asarray(cam.frustum, np.float32), np.asarray(cam.position, np.float32),
        width, height, xs, ys, U,
    )
    o = np.broadcast_to(o, d.shape)
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)


def _seeded_rays(scene, seed):
    """~2k rays: primary, random directions from points inside the scene,
    shadow-style rays with a finite ``maxt``, and some inactive lanes."""
    r = np.random.default_rng(seed)
    lo, hi = scene.bvh_min[0], scene.bvh_max[0]

    def inside(k):
        return (lo + r.uniform(0.05, 0.95, (k, 3)) * (hi - lo)).astype(np.float32)

    def unit(k):
        v = r.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    po, pd = _primary_rays(scene, 32, 24)  # 768
    ro, rd = inside(512), unit(512)
    so, target = inside(512), inside(512)
    seg = target - so
    dist = np.linalg.norm(seg, axis=-1)
    sd = (seg / dist[:, None]).astype(np.float32)
    smaxt = (dist * r.uniform(0.3, 1.2, 512)).astype(np.float32)
    io, idr = inside(256), unit(256)

    o = np.concatenate([po, ro, so, io])
    d = np.concatenate([pd, rd, sd, idr])
    maxt = np.concatenate(
        [np.full(768 + 512, FLT_MAX, np.float32), smaxt, np.full(256, FLT_MAX, np.float32)]
    )
    active = np.concatenate([np.ones(768 + 512 + 512, bool), np.zeros(256, bool)])
    return o, d, maxt, active


def _jax_scene_dict(scene):
    geom, params = scene.split_params()
    S = {k: (v if k.startswith("_") else jnp.asarray(v)) for k, v in geom.items()}
    S.update({k: jnp.asarray(v) for k, v in params.items()})
    return S


def _hit_to_numpy(hit):
    return {k: np.asarray(getattr(hit, k)) for k in ("t", "inst", "tri", "u", "v", "mask")}


def _torch_hit_to_numpy(hit):
    return {k: getattr(hit, k).numpy() for k in ("t", "inst", "tri", "u", "v", "mask")}


@pytest.fixture(scope="module")
def compiled(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    return {
        name: compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
        for name in SCENES
    }


@pytest.fixture(scope="module")
def cases(compiled):
    """Per scene: the rays, the port's results and the JAX package's, each
    traversal run once."""
    out = {}
    for k, name in enumerate(SCENES):
        scene = compiled[name]
        o, d, maxt, active = _seeded_rays(scene, seed=k)
        S_t = upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")
        rays_t = tuple(torch.from_numpy(x) for x in (o, d, maxt, active))
        S_j = _jax_scene_dict(scene)
        rays_j = tuple(jnp.asarray(x) for x in (o, d, maxt, active))
        rec = {"rays": (o, d, maxt, active), "S_t": S_t, "rays_t": rays_t}
        for any_hit in (False, True):
            key = "any" if any_hit else "closest"
            rec["torch", key] = _torch_hit_to_numpy(
                tix.intersect_bvh(S_t, *rays_t, any_hit=any_hit, leaf="quot")
            )
            rec["bvh", key] = _hit_to_numpy(
                jax.jit(jix.intersect_bvh, static_argnames="any_hit")(
                    S_j, *rays_j, any_hit=any_hit
                )
            )
            rec["packet", key] = _hit_to_numpy(
                jax.jit(intersect_packet, static_argnames=("any_hit", "rays_per_tile"))(
                    S_j, *rays_j, any_hit=any_hit
                )
            )
        for mode in ("packet", "brute"):
            closest, occluded = tix.make_intersectors(S_t, mode)
            rec[f"torch_{mode}", "closest"] = _torch_hit_to_numpy(closest(S_t, *rays_t))
            rec[f"torch_{mode}", "any"] = {"mask": occluded(S_t, *rays_t).numpy()}
        # the JAX brute any hit is its closest hit's mask
        closest, _ = jix.make_intersectors(S_j, scene, "brute")
        rec["brute", "closest"] = _hit_to_numpy(jax.jit(closest)(S_j, *rays_j))
        rec["brute", "any"] = {"mask": rec["brute", "closest"]["mask"]}
        out[name] = rec
    return out


def _assert_closest_agrees(got, ref, active, label):
    n = active.shape[0]
    assert got["t"].dtype == np.float32 and got["tri"].dtype == np.int32
    assert got["mask"].dtype == bool and got["mask"].shape == (n,)
    assert np.isfinite(got["t"]).all()
    assert not got["mask"][~active].any()
    assert (got["t"][~got["mask"]] == 0).all()
    both = got["mask"] & ref["mask"]
    same = both & (got["tri"] == ref["tri"]) & (got["inst"] == ref["inst"])
    odd = (got["mask"] != ref["mask"]) | (both & ~same)
    n_odd = int(odd.sum())
    print(f"{label}: {n_odd} of {n} lanes differ in mask/tri/inst "
          f"(allowed {int(MAX_TIE_SHARE * n)}); {int(both.sum())} hits")
    assert n_odd <= int(MAX_TIE_SHARE * n), label
    assert both.sum() > 0.3 * n, label  # the batch really hits geometry
    np.testing.assert_allclose(
        got["t"][same], ref["t"][same], rtol=RTOL, atol=ATOL, err_msg=f"{label}/t"
    )
    for k in ("u", "v"):
        a, b = got[k][same], ref[k][same]
        loose = int((np.abs(a - b) > ATOL + RTOL * np.abs(b)).sum())
        print(f"{label}/{k}: {loose} lanes outside rtol={RTOL}, atol={ATOL}; "
              f"max abs diff {float(np.abs(a - b).max()):.2e}")
        np.testing.assert_allclose(a, b, rtol=0, atol=UV_ATOL, err_msg=f"{label}/{k}")
    # another triangle on the same lane is only acceptable as a tie in t
    tie = both & ~same
    np.testing.assert_allclose(got["t"][tie], ref["t"][tie], rtol=RTOL, atol=ATOL)


def _assert_any_agrees(got, ref, active, label):
    n = active.shape[0]
    assert not got["mask"][~active].any()
    n_odd = int((got["mask"] != ref["mask"]).sum())
    print(f"{label}: {n_odd} of {n} occlusion lanes differ "
          f"(allowed {int(MAX_TIE_SHARE * n)}); {int(got['mask'].sum())} occluded")
    assert n_odd <= int(MAX_TIE_SHARE * n), label


@pytest.mark.parametrize("ref_name", ["bvh", "packet"])
@pytest.mark.parametrize("name", SCENES)
def test_closest_hit_matches_jax(cases, name, ref_name):
    rec = cases[name]
    _assert_closest_agrees(
        rec["torch", "closest"], rec[ref_name, "closest"], rec["rays"][3],
        f"{name}/closest/{ref_name}",
    )


@pytest.mark.parametrize("ref_name", ["bvh", "packet"])
@pytest.mark.parametrize("name", SCENES)
def test_any_hit_matches_jax(cases, name, ref_name):
    rec = cases[name]
    _assert_any_agrees(
        rec["torch", "any"], rec[ref_name, "any"], rec["rays"][3],
        f"{name}/any/{ref_name}",
    )


@pytest.mark.parametrize("mode", ["packet", "brute"])
@pytest.mark.parametrize("name", SCENES)
def test_xla_traversals_match_jax(cases, name, mode):
    """The port's ``mode="packet"`` / ``"brute"`` against the JAX
    ``intersect_packet`` / ``intersect_brute``: closest hit and any hit."""
    rec = cases[name]
    active = rec["rays"][3]
    _assert_closest_agrees(
        rec[f"torch_{mode}", "closest"], rec[mode, "closest"], active, f"{name}/closest/{mode}"
    )
    _assert_any_agrees(rec[f"torch_{mode}", "any"], rec[mode, "any"], active, f"{name}/any/{mode}")


@pytest.mark.parametrize("name", SCENES)
def test_any_hit_is_consistent_with_closest_hit(cases, name):
    """A lane is occluded exactly when its closest hit lies before maxt:
    both queries apply the same ``EPS < t < maxt`` window."""
    rec = cases[name]
    assert np.array_equal(rec["torch", "any"]["mask"], rec["torch", "closest"]["mask"])
    # the finite-maxt lanes must hold both outcomes for the check to bite
    shadow = slice(768 + 512, 768 + 1024)
    m = rec["torch", "any"]["mask"][shadow]
    assert m.any() and (~m).any()


def test_instanced_scene_reaches_several_instances(cases):
    """The TLAS / transform / restore path is really exercised."""
    hit = cases["instanced"]["torch", "closest"]
    assert len(np.unique(hit["inst"][hit["mask"]])) >= 3


@pytest.mark.parametrize("name", SCENES)
def test_wrappers_use_the_plain_version_on_cpu_tensors(cases, name):
    """``intersect_cuda.closest_hit`` / ``any_hit`` on CPU tensors run the
    kernel's plain version (the det²-scaled leaf test) on K1's packed scene,
    count no kernel launch, and are what 'auto' gives on a CPU scene; 'bvh'
    stays the quotient form."""
    rec = cases[name]
    before = dict(intersect_cuda.LAUNCHES)
    closest, any_hit = tix.make_intersectors(rec["S_t"], "auto", tri_test="mt")
    P = closest.packed
    assert P["leaf"] == "det2" and "k1_words" in P
    hit = intersect_cuda.closest_hit(P, *rec["rays_t"])
    occluded = intersect_cuda.any_hit(P, *rec["rays_t"])
    for k, v in _torch_hit_to_numpy(closest(rec["S_t"], *rec["rays_t"])).items():
        np.testing.assert_array_equal(v, _torch_hit_to_numpy(hit)[k], err_msg=k)
    np.testing.assert_array_equal(any_hit(rec["S_t"], *rec["rays_t"]).numpy(), occluded.numpy())
    assert intersect_cuda.LAUNCHES == before
    want = _torch_hit_to_numpy(
        tix.intersect_bvh(rec["S_t"], *rec["rays_t"], any_hit=False, leaf="det2")
    )
    for k, v in _torch_hit_to_numpy(hit).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    want_any = tix.intersect_bvh(
        rec["S_t"], *rec["rays_t"], any_hit=True, leaf="det2"
    ).mask.numpy()
    np.testing.assert_array_equal(occluded.numpy(), want_any)
    closest, any_hit = tix.make_intersectors(rec["S_t"], "bvh")
    quot = rec["torch", "closest"]
    for k, v in _torch_hit_to_numpy(closest(rec["S_t"], *rec["rays_t"])).items():
        np.testing.assert_array_equal(v, quot[k], err_msg=k)
    np.testing.assert_array_equal(
        any_hit(rec["S_t"], *rec["rays_t"]).numpy(), rec["torch", "any"]["mask"]
    )
    # the two forms round differently and agree to a few ulps
    same = want["mask"] & quot["mask"] & (want["tri"] == quot["tri"])
    assert same.sum() >= 0.999 * quot["mask"].sum()
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(want[k][same], quot[k][same], rtol=RTOL, atol=ATOL)


def test_all_inactive_and_empty_batches(cases):
    rec = cases["sphere"]
    o, d, maxt, active = rec["rays_t"]
    dead = torch.zeros_like(active)
    for any_hit in (False, True):
        hit = tix.intersect_bvh(rec["S_t"], o, d, maxt, dead, any_hit=any_hit, leaf="quot")
        assert not hit.mask.any() and (hit.t == 0).all()
        none = tix.intersect_bvh(
            rec["S_t"], o[:0], d[:0], maxt[:0], active[:0], any_hit=any_hit, leaf="quot"
        )
        assert none.mask.shape == (0,)


def test_traversal_stats_count_the_work(cases):
    """The counters behind chip_smoke's arithmetic bound: every active ray
    visits the root, a hit needs at least one triangle test, the instanced
    scene enters instances, and counting changes no result."""
    for name in ("sphere", "instanced"):
        rec = cases[name]
        stats = {}
        hit = tix.intersect_bvh(
            rec["S_t"], *rec["rays_t"], any_hit=False, stats=stats, leaf="quot"
        )
        np.testing.assert_array_equal(hit.tri.numpy(), rec["torch", "closest"]["tri"])
        n_active = int(rec["rays"][3].sum())
        assert stats["tris"] >= int(hit.mask.sum())
        assert stats["inst"] >= int(hit.mask.sum())  # one entry per hit at least
        assert stats["inner"] >= n_active or name == "sphere"
        assert stats["trips"] > 0


@pytest.fixture(scope="module")
def pallas_batch(compiled):
    """One BLOCK_RAYS batch of cornell rays: 128x128 primaries; the any-hit
    call gives every second lane a short ``maxt`` and switches some lanes
    off."""
    from polaris_tpu.ops.intersect_pallas import BLOCK_RAYS

    scene = compiled["cornell"]
    o, d = _primary_rays(scene, 128, 128, seed=3)
    assert o.shape[0] == BLOCK_RAYS
    r = np.random.default_rng(7)
    maxt_any = np.where(
        np.arange(BLOCK_RAYS) % 2 == 0, r.uniform(0.5, 6.0, BLOCK_RAYS), FLT_MAX
    ).astype(np.float32)
    active = r.uniform(size=BLOCK_RAYS) > 0.05
    return scene, o, d, maxt_any, active


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_matches_the_pallas_kernel_in_interpret_mode(pallas_batch, any_hit):
    from polaris_tpu.ops.intersect_pallas import intersect_pallas, pack_scene

    scene, o, d, maxt_any, active = pallas_batch
    maxt = maxt_any if any_hit else np.full(o.shape[0], FLT_MAX, np.float32)
    P = {k: jnp.asarray(v) for k, v in pack_scene(scene).items()}
    ref = _hit_to_numpy(
        intersect_pallas(
            P, jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt), jnp.asarray(active),
            any_hit=any_hit,
        )
    )
    S_t = upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")
    got = _torch_hit_to_numpy(
        tix.intersect_bvh(
            S_t, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(maxt),
            torch.from_numpy(active), any_hit=any_hit, leaf="quot",
        )
    )
    if any_hit:
        _assert_any_agrees(got, ref, active, "cornell/any/pallas")
        assert got["mask"].any() and (~got["mask"][active]).any()
    else:
        _assert_closest_agrees(got, ref, active, "cornell/closest/pallas")
