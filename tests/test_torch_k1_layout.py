"""K1's packed scene, its stack depth and staging rule, and the per-lane work
counts of its plain version, on the CPU.

The kernel ``csrc/intersect.cu`` reads one buffer of 16-byte words that
``ops/intersect_cuda.py::pack_scene_k1`` builds once per scene; its plain
version (``k1_plain``) reads the same buffer. Here, on the compiled scenes of
``scenes/`` (no Pallas, no JAX call):

  * the packer is lossless: the records and rows give back the scene's own
    arrays bit for bit
  * its ``stack_need`` bounds the deepest stack the plain version reaches on
    each scene's 32x32 primary rays
  * the shared-memory rule stages the five benchmark scenes and leaves a
    scene whose bytes exceed the budget in global memory (counts only)
  * mode 'kernel' refuses a CPU scene, 'auto' gives K1's plain version
  * the per-lane counts of ``traverse_binary`` sum to its totals, and the
    SIMT ceilings of a hand-built 64-lane case equal the values worked out
    by hand
"""

import os
import re
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.ops import intersect as tix  # noqa: E402
from polaris_tpu_torch.ops import intersect_cuda as k1  # noqa: E402
from polaris_tpu_torch.ops import rng  # noqa: E402
from polaris_tpu_torch.render.integrator import TorchRenderer  # noqa: E402
from polaris_tpu_torch.render.options import RenderOptions  # noqa: E402
from polaris_tpu_torch.render.raygen import gen_rays  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402

SCENES = ["sphere", "instanced", "cornell", "mitsuba", "dispersive"]
FLT_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module")
def compiled(scenes_dir):
    return {
        name: compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
        for name in SCENES
    }


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("leaf", ["det2", "hh"])
@pytest.mark.parametrize("name", SCENES)
def test_packer_is_lossless(compiled, name, leaf):
    scene = compiled[name]
    P = k1.pack_scene_k1(scene, leaf)
    n, t, i = P["num_nodes"], P["num_tris"], P["num_inst"]
    words = P["k1_words"]
    assert words.dtype == np.int32 and words.size % 4 == 0
    rec = words[: 4 * P["tri_at"]].reshape(n, 16)
    rows = words[4 * P["tri_at"]: 4 * P["inst_at"]].reshape(t, 12)
    inst = words[4 * P["inst_at"]:].reshape(i, 16)
    assert np.array_equal(rec[:, 0], scene.bvh_ldata)
    assert np.array_equal(rec[:, 1], scene.bvh_rdata)
    # each child's box lies in its parent's record; the roots' own boxes
    # (node 0, the BLAS roots) are read by no traversal
    inner = np.flatnonzero(scene.bvh_ldata > 0)
    lc, rc = scene.bvh_ldata[inner], scene.bvh_rdata[inner]
    for kids, at in ((lc, 2), (rc, 8)):
        assert np.array_equal(rec[inner, at:at + 3], _bits(scene.bvh_min[kids]))
        assert np.array_equal(rec[inner, at + 3:at + 6], _bits(scene.bvh_max[kids]))
    reached = np.zeros(n, bool)
    reached[lc] = reached[rc] = True
    reached[0] = True
    reached[scene.inst_bvh_root] = True
    assert reached.all()  # every box of the scene is in the buffer or never read
    if leaf == "det2":
        for at, field in ((0, "tri_v0"), (4, "tri_e1"), (8, "tri_e2")):
            assert np.array_equal(rows[:, at:at + 3], _bits(getattr(scene, field)))
        assert (rows[:, 3::4] == 0).all()
    else:
        assert np.array_equal(rows.view(np.float32).ravel(), tix.pack_tris_hh(scene))
    assert np.array_equal(inst[:, :12], _bits(scene.inst_w2o[:, :3, :].reshape(i, 12)))
    assert np.array_equal(inst[:, 12], scene.inst_bvh_root)
    # and the plain version reads the same scene back through its layout
    L = k1.k1_layout(k1.upload_k1(P, "cpu"))
    assert torch.equal(L.roots, torch.from_numpy(scene.inst_bvh_root.astype(np.int32)))
    assert torch.equal(L.w2o, torch.from_numpy(scene.inst_w2o[:, :3, :].astype(np.float32)))


def _primary_rays(scene, width=32, height=32):
    """The 32x32 primary rays of sample 0, as the renderer makes them."""
    r = TorchRenderer(scene, device="cpu", mode="bvh")
    opt = RenderOptions(width=width, height=height)
    xs, ys, pix, _ = r._pixel_order(width, height)
    frustum, eye = r._camera_tensors(opt, None)
    o, d = gen_rays(frustum, eye, width, height, xs, ys, rng.make_uniform(0, pix, 0, 0))
    n = width * height
    return o, d, torch.full((n,), FLT_MAX), torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("name", SCENES)
def test_stack_need_bounds_the_plain_stack(compiled, name):
    scene = compiled[name]
    P = k1.upload_k1(k1.pack_scene_k1(scene, "det2"), "cpu")
    stats = {"per_lane": True}
    hit = k1.k1_plain(P, *_primary_rays(scene), any_hit=False, stats=stats)
    assert hit.mask.any()
    assert 1 <= stats["stack_peak"] <= P["stack_need"] <= tix.STACK_SIZE
    assert P["stack_cap"] == P["stack_need"]


def test_shared_memory_rule():
    # the five benchmark scenes, by their counts (nodes, triangles,
    # instances, stack): staged in shared memory
    for counts in (
        (80, 1284, 3, 8), (56, 324, 18, 10), (53, 36, 18, 8), (155, 2564, 4, 9),
        (77, 1282, 2, 7),
    ):
        assert k1.staging(*counts)[0] == "shared", counts
    # bytes: 64 per node, 48 per triangle, 64 per instance, 4 per stack
    # entry of each of the block's threads
    assert k1.staging(155, 2564, 4, 9)[1] == 64 * 155 + 48 * 2564 + 64 * 4 + 4 * 9 * k1.THREADS
    # a terrain of 320,002 triangles: 15 MB of rows, in global memory
    assert k1.staging(17_000, 320_002, 1, 30)[0] == "global"
    # the edge of the budget: the most triangles that fit beside one node,
    # one instance and a stack of 10, then one triangle more
    fixed = 64 + 64 + 4 * 10 * k1.THREADS
    most = (k1.SMEM_BUDGET - fixed) // 48
    assert k1.staging(1, most, 1, 10) == ("shared", fixed + 48 * most)
    assert k1.staging(1, most + 1, 1, 10)[0] == "global"
    # the rule's block size is the kernel's
    src = open(os.path.join(os.path.dirname(k1.__file__), "..", "csrc", k1.SOURCE)).read()
    assert int(re.search(r"K1_THREADS = (\d+);", src).group(1)) == k1.THREADS


def test_kernel_mode_raises_and_auto_is_the_plain_version_on_cpu(compiled):
    scene = compiled["cornell"]
    S = upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tix.make_intersectors(S, mode="kernel")
    rays = _primary_rays(scene, 16, 16)
    before = dict(k1.LAUNCHES)
    for tri_test, leaf in (("mt", "det2"), ("hh", "hh")):
        closest, occluded = tix.make_intersectors(S, mode="auto", tri_test=tri_test)
        assert closest.packed["leaf"] == leaf
        hh = closest.tris_hh if leaf == "hh" else None
        want = tix.intersect_bvh(S, *rays, any_hit=False, leaf=leaf, tris_hh=hh)
        got = closest(S, *rays)
        assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields)
        want_any = tix.intersect_bvh(S, *rays, any_hit=True, leaf=leaf, tris_hh=hh).mask
        assert torch.equal(occluded(S, *rays), want_any)
    assert k1.LAUNCHES == before  # no launch on a CPU scene
    with pytest.raises(ValueError, match="packed for leaf"):
        k1.closest_hit_hh(tix.make_intersectors(S, "auto", tri_test="mt")[0].packed, *rays)


def test_per_lane_counts_and_simt_ceilings(compiled):
    # 64 hand-made lanes through cornell: from inside the box towards the
    # walls, half of them inactive, a quarter as shadow rays with a short maxt
    scene = compiled["cornell"]
    P = k1.upload_k1(k1.pack_scene_k1(scene, "det2"), "cpu")
    lo, hi = scene.bvh_min[0], scene.bvh_max[0]
    g = np.random.default_rng(7)
    o = (lo + g.uniform(0.2, 0.8, (64, 3)) * (hi - lo)).astype(np.float32)
    d = g.normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.where(np.arange(64) % 4 == 3, 0.5, FLT_MAX).astype(np.float32)
    active = np.arange(64) % 2 == 1
    rays = tuple(torch.from_numpy(x) for x in (o, d, maxt, active))
    for any_hit in (False, True):
        stats = {"per_lane": True}
        k1.k1_plain(P, *rays, any_hit=any_hit, stats=stats)
        assert int(stats["lane_inner"].sum()) == stats["inner"] > 0
        assert int(stats["lane_tris"].sum()) == stats["tris"] > 0
        assert not stats["lane_inner"][~rays[3]].any()
        assert not stats["lane_tris"][~rays[3]].any()
    # the ceilings on a hand-built work vector: the odd lanes active, each
    # with 2 units of work but lanes 1 and 33 with 10. Launch order: two
    # warps of 40 units, each as long as its lane of 10:
    # 80 / (32 * (10 + 10)) = 0.125. Compacted: the 32 active lanes are one
    # warp of 80 units as long as 10: 80 / (32 * 10) = 0.25
    work = torch.zeros(64, dtype=torch.int64)
    live = torch.arange(64) % 2 == 1
    work[live] = 2
    work[1] = work[33] = 10
    assert tix.simt_ceilings(work, live) == {"launch_order": 0.125, "compacted": 0.25}
    # a partial last warp counts as a whole one: 3 lanes of 1 -> 3 / 32
    assert tix.simt_ceilings(torch.ones(3, dtype=torch.int64), torch.ones(3, dtype=torch.bool)) == {
        "launch_order": 3 / 32, "compacted": 3 / 32,
    }
    none = tix.simt_ceilings(torch.zeros(5, dtype=torch.int64), torch.zeros(5, dtype=torch.bool))
    assert none == {"launch_order": None, "compacted": None}
