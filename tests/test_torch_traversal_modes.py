"""The port's four further traversal kernels (K2-K5) against the JAX package,
on the CPU: packers, plain versions, and the TPU kernels in interpret mode.

Each module of ``polaris_tpu_torch.ops`` that holds a CUDA kernel carries a
host packer and the kernel's plain PyTorch version; the kernels themselves
only run on a card, where ``chip_smoke.py`` holds each against its plain
version. Here, on seeded rays:

  * every packer yields arrays EQUAL to the JAX packer's for each key the
    port keeps (the record and triangle arrays of K2 and K3 cut to their
    unpadded length: the padding is DMA staging for the TPU)
  * every plain version is held against the port's ``intersect_bvh`` WITH
    ITS OWN LEAF FORM: the det²-scaled one for K2, K3 and K5 (the plain
    version of K1), the quotient form for K4. K3 walks the same tree in the
    same order and must agree on every field of every lane: K3 = K1 bit for
    bit, the TPU kernels' contract. The 8-wide and dense versions visit in
    another order: on coplanar overlapping geometry (cornell's light in the
    ceiling plane) a box's slab entry distance can round above a hit
    distance inside it, so which of two triangles of (almost) one ``t``
    survives depends on the order; the dense version also divides once per
    ray where the BVH versions divide once per leaf, so its acceptance
    compare rounds differently. Such lanes are COUNTED (at most
    ``MAX_TIE_SHARE``) and must report the same ``t`` to ``rtol=1e-5,
    atol=1e-6``; every other lane must be equal in every field
  * every plain version is held against the JAX package's ``bvh`` and
    ``packet`` traversals (quotient form: ``t`` rtol 1e-5 / atol 1e-6,
    ``u, v`` atol 1e-4 as in tests/test_torch_intersect.py), and against its
    own TPU kernel in Pallas interpret mode on one 16,384-ray block (K2 and
    K3 with a 1 KB resident prefix, so that the streamed path is what is
    compared). Against its own TPU kernel a plain version now repeats the
    same algebraic form, and ``u, v`` are held to ``UV_ATOL_PALLAS``; what
    is left is XLA contracting multiply-add pairs into FMAs where PyTorch
    rounds each product. Mask / tri / inst equal but for counted ties.
"""

import os
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polaris_tpu.ops import intersect as jix  # noqa: E402
from polaris_tpu.ops.intersect_packet import intersect_packet  # noqa: E402
from polaris_tpu_torch.ops import (  # noqa: E402
    intersect as tix,
    intersect_dense,
    intersect_nodes,
    intersect_wide8,
    intersect_wide8_nodes,
)
from polaris_tpu_torch.ops._launch import upload_packed  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402
import test_torch_intersect as base  # noqa: E402
from test_torch_intersect import (  # noqa: E402
    _assert_any_agrees,
    _assert_closest_agrees,
    _hit_to_numpy,
    _jax_scene_dict,
    _primary_rays,
    _seeded_rays,
    _torch_hit_to_numpy,
)

FLT_MAX = np.float32(3.4028235e38)
RTOL, ATOL = 1e-5, 1e-6
# lanes that may keep another triangle of the same t: the 8-wide and dense
# orders meet cornell's coplanar light and ceiling more often than the binary
# order does (5 of 2048 seeded rays against tests/test_torch_intersect.py's 4)
MAX_TIE_SHARE = 5e-3
# u, v of a plain version against its own TPU kernel in interpret mode (was
# 1e-4 while the port ran one quotient-form test against det²-scaled kernels)
UV_ATOL_PALLAS = 5e-6
# the leaf form each kernel's plain version runs
LEAF = {"K2": "det2", "K3": "det2", "K4": "quot", "K5": "det2"}


@pytest.fixture(autouse=True)
def _tie_share(monkeypatch):
    """The shared assertions count ties against this file's share."""
    monkeypatch.setattr(base, "MAX_TIE_SHARE", MAX_TIE_SHARE)

SCENES = ["cornell", "instanced", "terrain32"]

# kernel -> (module, packer, plain version, JAX module, JAX packer,
#            keys cut to the port's length, keys the port adds)
KERNELS = {
    "K2": (
        intersect_wide8_nodes, "pack_scene8_nodes", "wide8_nodes_plain",
        "intersect_pallas8_nodes", "pack_scene8_nodes",
        ("p8n_nodes", "p8n_tris"), ("root_entry", "stack_need"),
    ),
    "K3": (
        intersect_nodes, "pack_scene_nodes", "nodes_plain",
        "intersect_pallas_nodes", "pack_scene_nodes",
        ("pn_nodes", "pn_tris"), (),
    ),
    "K4": (
        intersect_wide8, "pack_scene8", "wide8_plain",
        "intersect_pallas8", "pack_scene8", (), ("root_entry", "stack_need"),
    ),
    "K5": (
        intersect_dense, "pack_scene_dense", "dense_plain",
        "intersect_pallas_dense", "pack_scene_dense", (), (),
    ),
}


def _scene_dict(scene):
    return {f.name: getattr(scene, f.name) for f in fields(scene)}


@pytest.fixture(scope="module")
def compiled(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.procedural import make_terrain_scene
    from polaris_tpu.asset.wavefront import read_scene

    out = {
        name: compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
        for name in ("cornell", "instanced")
    }
    out["terrain32"] = compile_scene(make_terrain_scene(grid=32))
    return out


@pytest.fixture(scope="module")
def cases(compiled):
    """Per scene: seeded rays, the uploaded scene, the port's
    ``intersect_bvh`` results and the JAX package's ``bvh`` / ``packet``."""
    out = {}
    for k, name in enumerate(SCENES):
        scene = compiled[name]
        o, d, maxt, active = _seeded_rays(scene, seed=10 + k)
        rays_t = tuple(torch.from_numpy(x) for x in (o, d, maxt, active))
        S_t = upload_scene(_scene_dict(scene), "cpu")
        S_j = _jax_scene_dict(scene)
        rays_j = tuple(jnp.asarray(x) for x in (o, d, maxt, active))
        rec = {"active": active, "rays_t": rays_t, "S_t": S_t}
        for any_hit in (False, True):
            for leaf in ("quot", "det2"):
                rec["port", leaf, any_hit] = tix.intersect_bvh(
                    S_t, *rays_t, any_hit=any_hit, leaf=leaf
                )
            rec["bvh", any_hit] = _hit_to_numpy(
                jax.jit(jix.intersect_bvh, static_argnames="any_hit")(
                    S_j, *rays_j, any_hit=any_hit
                )
            )
            rec["packet", any_hit] = _hit_to_numpy(
                jax.jit(intersect_packet, static_argnames=("any_hit", "rays_per_tile"))(
                    S_j, *rays_j, any_hit=any_hit
                )
            )
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def packed(compiled):
    """(kernel, scene) -> the port's packed scene on the CPU, packed once."""
    cache = {}

    def get(kernel, name):
        if (kernel, name) not in cache:
            module, packer = KERNELS[kernel][:2]
            host = getattr(module, packer)(compiled[name])
            cache[kernel, name] = (host, upload_packed(host, "cpu"))
        return cache[kernel, name]

    return get


@pytest.fixture(scope="module")
def plain_hits(cases, packed):
    """(kernel, scene, any_hit) -> the plain version's ``Hit``, run once."""
    cache = {}

    def get(kernel, name, any_hit):
        key = (kernel, name, any_hit)
        if key not in cache:
            module, _, plain = KERNELS[kernel][:3]
            cache[key] = getattr(module, plain)(
                packed(kernel, name)[1], *cases[name]["rays_t"], any_hit=any_hit
            )
        return cache[key]

    return get


# ------------------------------------------------------------------ packers


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_packer_equals_the_jax_packer(compiled, packed, kernel, name):
    import importlib

    _, _, _, jax_module, jax_packer, cut, added = KERNELS[kernel]
    theirs = getattr(
        importlib.import_module(f"polaris_tpu.ops.{jax_module}"), jax_packer
    )(compiled[name])
    ours = packed(kernel, name)[0]
    kept = [k for k in ours if k not in added]
    assert kept and set(kept) <= set(theirs)
    for k in kept:
        want = np.asarray(theirs[k])
        if k in cut:
            assert want.size > ours[k].size  # the JAX array is padded
            assert not want[ours[k].size:].any()  # and the padding is zeros
            want = want[: ours[k].size]
        assert ours[k].dtype == want.dtype, k
        assert np.array_equal(ours[k], want), k
    for k in added:
        assert isinstance(ours[k], int), k


def test_wide_collapse_limits(compiled):
    """The stack bound is worked out from the packed tree, and an entry that
    does not fit its bit field raises instead of wrapping."""
    host = intersect_wide8_nodes.pack_scene8_nodes(compiled["terrain32"])
    assert 0 < host["stack_need"] <= intersect_wide8.STACK_SIZE
    assert host["root_entry"] == int(host["p8n_root"][0])
    with pytest.raises(ValueError, match="out of range"):
        intersect_wide8.entry22(intersect_wide8.T_BOT, 1 << 22, 1)
    with pytest.raises(ValueError, match="out of range"):
        intersect_wide8_nodes.entry24(intersect_wide8.T_BOT, 5, 64)
    with pytest.raises(ValueError, match="traversal stack"):
        intersect_wide8.check_stack(intersect_wide8.STACK_SIZE + 1)
    # the light is a one-leaf mesh: its instance entry is a leaf entry, typ 2
    # sets bit 31, the stored int32 is negative and decoding masks the sign
    e = int(host["p8n_inst_entry"][1])
    typ, cnt, idx = intersect_wide8_nodes.unpack24(e)
    assert e < 0 and typ == intersect_wide8.T_BOT and cnt == 2
    assert 0 <= idx < compiled["terrain32"].tri_v0.shape[0]


# ---------------------------------------------------- plain versions, port


def _assert_equal_but_for_ties(got, ref, label, allow_ties):
    n = ref.mask.shape[0]
    assert torch.equal(got.mask, ref.mask), label
    odd = (got.tri != ref.tri) | (got.inst != ref.inst)
    n_odd = int(odd.sum())
    print(f"{label}: {n_odd} of {n} lanes keep another triangle of the same t")
    assert n_odd <= (int(MAX_TIE_SHARE * n) if allow_ties else 0), label
    np.testing.assert_allclose(
        got.t[odd].numpy(), ref.t[odd].numpy(), rtol=RTOL, atol=ATOL, err_msg=label
    )
    for f in ("t", "u", "v"):
        assert torch.equal(getattr(got, f)[~odd], getattr(ref, f)[~odd]), (label, f)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_version_equals_intersect_bvh(cases, plain_hits, kernel, name, any_hit):
    ref = cases[name]["port", LEAF[kernel], any_hit]
    got = plain_hits(kernel, name, any_hit)
    assert got.t.dtype == torch.float32 and got.tri.dtype == torch.int32
    if any_hit:
        assert torch.equal(got.mask, ref.mask)
        assert got.mask.any() and (~got.mask[torch.from_numpy(cases[name]["active"])]).any()
    else:
        _assert_equal_but_for_ties(
            got, ref, f"{kernel}/{name}", allow_ties=(kernel != "K3")
        )
        assert got.mask.sum() > 0.3 * got.mask.shape[0]


# ----------------------------------------------- plain versions, JAX package


@pytest.mark.parametrize("ref_name", ["bvh", "packet"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_version_matches_jax(cases, plain_hits, kernel, name, any_hit, ref_name):
    got = _torch_hit_to_numpy(plain_hits(kernel, name, any_hit))
    ref = cases[name][ref_name, any_hit]
    label = f"{kernel}/{name}/{ref_name}"
    if any_hit:
        _assert_any_agrees(got, ref, cases[name]["active"], label)
    else:
        _assert_closest_agrees(got, ref, cases[name]["active"], label)


def test_terrain_and_instanced_reach_two_levels(cases, plain_hits):
    """The instance entry inside a wide node, the transform and the restore
    are really exercised: hits land in several instances."""
    for name, least in (("instanced", 3), ("terrain32", 2)):
        hit = plain_hits("K2", name, False)
        assert len(torch.unique(hit.inst[hit.mask])) >= least, name


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_version_counts_the_work(cases, compiled, packed, plain_hits, kernel):
    """The counts behind a kernel's bound: the instrumented run returns the
    same hits; distinct records read never exceed the scene nor the reads; an
    any-hit ray stops inside a leaf, so it tests fewer triangles than closest
    hit; a wide visit slab-tests its non-empty slots only."""
    name = "cornell" if kernel == "K5" else "terrain32"
    module, _, plain = KERNELS[kernel][:3]
    P = packed(kernel, name)[1]
    rays = cases[name]["rays_t"]
    n_active = int(cases[name]["active"].sum())
    stats = {}
    for any_hit in (False, True):
        st = stats[any_hit] = {}
        hit = getattr(module, plain)(P, *rays, any_hit=any_hit, stats=st)
        assert torch.equal(hit.mask, plain_hits(kernel, name, any_hit).mask)
        assert 0 < st["tris_touched"] <= compiled[name].tri_v0.shape[0]
        assert st["tris_touched"] <= st["tris"]
        assert 0 < st["inst_touched"] <= compiled[name].inst_w2o.shape[0]
        assert st["inst_touched"] <= st["inst"]
        assert st["nodes_touched"] <= st["inner"] + st["inst"] + st["tris"]
        if kernel == "K5":
            assert st["inner"] == st["slabs"] == st["nodes_touched"] == 0
        else:
            assert st["nodes_touched"] > 0 and st["inner"] >= n_active
    closest, occluded = stats[False], stats[True]
    assert occluded["tris"] < closest["tris"]
    if kernel == "K5":
        assert closest["tris"] == n_active * compiled[name].tri_v0.shape[0]
    elif kernel == "K3":
        assert closest["slabs"] == 2 * closest["inner"]
    else:
        assert closest["inner"] < closest["slabs"] < 8 * closest["inner"]


# ------------------------------------------- the TPU kernels, interpret mode


@pytest.fixture(scope="module")
def pallas_batch(compiled):
    """One 16,384-ray block of cornell primaries (128x128)."""
    scene = compiled["cornell"]
    o, d = _primary_rays(scene, 128, 128, seed=5)
    r = np.random.default_rng(11)
    active = r.uniform(size=o.shape[0]) > 0.05
    maxt = np.full(o.shape[0], FLT_MAX, np.float32)
    return scene, o, d, maxt, active


def _pallas_call(kernel, scene, rays):
    if kernel == "K2":
        from polaris_tpu.ops.intersect_pallas8_nodes import (
            BLOCK_RAYS, intersect_pallas8_nodes, pack_scene8_nodes,
        )

        P = pack_scene8_nodes(scene, resident_bytes=1024)
        assert P["p8n_resident"] == 1  # every other node is streamed
        fn = intersect_pallas8_nodes
        static = ("p8n_resident",)
        kw = {}
    elif kernel == "K3":
        from polaris_tpu.ops.intersect_pallas_nodes import (
            BLOCK_RAYS, intersect_pallas_nodes, pack_scene_nodes,
        )

        P = pack_scene_nodes(scene, resident_bytes=1024)
        assert P["pn_resident"] == 1  # every other node is streamed
        fn = intersect_pallas_nodes
        static = ("pn_resident",)
        kw = {}
    elif kernel == "K4":
        from polaris_tpu.asset.compiler.compiler import MIN_PRIMITIVES_PER_LEAF
        from polaris_tpu.ops.intersect_pallas8 import (
            BLOCK_RAYS, intersect_pallas8, pack_scene8,
        )

        P = pack_scene8(scene)
        fn = intersect_pallas8
        static = ()
        kw = {"max_leaf": MIN_PRIMITIVES_PER_LEAF}
    else:
        from polaris_tpu.ops.intersect_pallas_dense import (
            BLOCK_RAYS, intersect_pallas_dense, pack_scene_dense,
        )

        P = pack_scene_dense(scene)
        fn = intersect_pallas_dense
        static = ()
        kw = {}
    assert rays[0].shape[0] == BLOCK_RAYS
    P = {k: (v if k in static else jnp.asarray(v)) for k, v in P.items()}
    return _hit_to_numpy(fn(P, *(jnp.asarray(x) for x in rays), any_hit=False, **kw))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_version_matches_the_pallas_kernel(
    pallas_batch, packed, kernel, monkeypatch
):
    monkeypatch.setattr(base, "UV_ATOL", UV_ATOL_PALLAS)
    scene, o, d, maxt, active = pallas_batch
    ref = _pallas_call(kernel, scene, (o, d, maxt, active))
    module, _, plain = KERNELS[kernel][:3]
    got = _torch_hit_to_numpy(
        getattr(module, plain)(
            packed(kernel, "cornell")[1],
            *(torch.from_numpy(x) for x in (o, d, maxt, active)), any_hit=False,
        )
    )
    _assert_closest_agrees(got, ref, active, f"{kernel}/cornell/pallas")
