"""K2's and K3's own buffers, their staging rule and stack depth, and the
per-lane work counts of their plain versions, on the CPU.

The kernels ``csrc/intersect_wide8_nodes.cu`` (K2) and
``csrc/intersect_nodes.cu`` (K3) run the persistent schedule of
``csrc/traverse_common.cuh`` over buffers of their own, which
``pack_scene_k2`` / ``pack_scene_k3`` build beside the arrays that equal the
JAX packers' (``pack_scene8_nodes`` / ``pack_scene_nodes``, held by
``tests/test_torch_traversal_modes.py``). Their plain versions read those
JAX-equal arrays. Here, on small scenes (instanced, sphere, a terrain of
2,050 and one of 20,002 triangles; no Pallas, no JAX call):

  * K2's own records decode losslessly to ``p8n_nodes``' boxes and entries,
    its triangle and instance rows to ``p8n_tris``, ``p8n_w2o`` and
    ``p8n_inst_entry``
  * K3's own buffer is K1's layout over the depth-ordered records: ``ld``,
    ``rd`` and the boxes of ``pn_nodes``, 48-byte triangle rows of
    ``pn_tris``, instance rows of ``pn_w2o`` and ``pn_roots``
  * the staging rule, K1's: the whole buffer in shared memory where it fits
    beside the stacks, else none of it (the TPU kernels' resident prefix of
    records, timed on the H100 at three sizes, read slower than none); the
    records are in depth order either way
  * ``stack_need`` bounds the per-lane stack peak of both plain versions
  * the per-lane counts sum to the ``stats`` totals
  * the 'auto' rule picks what ``make_intersectors``' docstring says
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.procedural import make_terrain_scene  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.ops import intersect as tix  # noqa: E402
from polaris_tpu_torch.ops import intersect_cuda as k1  # noqa: E402
from polaris_tpu_torch.ops import intersect_nodes as k3  # noqa: E402
from polaris_tpu_torch.ops import intersect_wide8 as wide  # noqa: E402
from polaris_tpu_torch.ops import intersect_wide8_nodes as k2  # noqa: E402
from polaris_tpu_torch.ops._launch import upload_packed  # noqa: E402

SCENES = ["instanced", "sphere", "terrain32", "terrain100"]
FLT_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module")
def compiled(scenes_dir):
    out = {
        name: compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
        for name in ("instanced", "sphere")
    }
    for grid in (32, 100):
        out[f"terrain{grid}"] = compile_scene(make_terrain_scene(grid=grid))
    return out


@pytest.fixture(scope="module")
def packed(compiled):
    """scene -> (K3's arrays + own buffer, K2's arrays + own buffer), host."""
    out = {}
    for name, scene in compiled.items():
        pn = k3.pack_scene_nodes(scene)
        p8n = k2.pack_scene8_nodes(scene)
        out[name] = ({**pn, **k3.pack_scene_k3(pn)}, {**p8n, **k2.pack_scene_k2(p8n)})
    return out


def _rays(scene, seed, n=768):
    """Seeded rays from points inside the scene's box: random directions,
    every fourth with a short ``maxt`` (shadow-like), every eighth inactive."""
    g = np.random.default_rng(seed)
    lo, hi = scene.bvh_min[0], scene.bvh_max[0]
    o = (lo + g.uniform(0.05, 0.95, (n, 3)) * (hi - lo)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.where(np.arange(n) % 4 == 3, 0.3 * np.linalg.norm(hi - lo), FLT_MAX)
    active = np.arange(n) % 8 != 5
    return tuple(torch.from_numpy(x) for x in (o, d, maxt.astype(np.float32), active))


def _split(words, counts):
    """A buffer of int32 16-byte words cut into rows of the given widths (in
    words) and counts, in order."""
    out, at = [], 0
    for width, count in counts:
        out.append(words[at: at + 4 * width * count].reshape(count, 4 * width))
        at += 4 * width * count
    assert at == words.size
    return out


@pytest.mark.parametrize("name", SCENES)
def test_k2_records_decode_to_the_packer_arrays(packed, name):
    P = packed[name][1]
    n, t, i = P["num_wide"], P["num_tris"], P["num_inst"]
    rec, tris, inst = _split(P["k2_words"], [(k2.REC_WORDS, n), (3, t), (4, i)])
    nodes = P["p8n_nodes"].reshape(n, k2.REC)
    # twelve words of boxes: the 48 floats in order, child c at [6c, 6c+6)
    assert np.array_equal(rec[:, :48].view(np.float32), nodes[:, :48])
    # two words of ready entries; unpacked they are the float pairs (lo, hi)
    typ, cnt, idx = (a.astype(np.int64) for a in k2.unpack24(rec[:, 48:].astype(np.int64)))
    assert np.array_equal(idx.astype(np.float32), nodes[:, 48::2])
    assert np.array_equal((typ * 64 + cnt).astype(np.float32), nodes[:, 49::2])
    assert (typ[typ != wide.T_EMPTY] > 0).all() and (cnt < 64).all()
    # 48-byte triangle rows [v0, 0, e1, 0, e2, 0], instance rows [w2o, entry]
    rows = tris.view(np.float32)
    assert np.array_equal(rows[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].ravel(), P["p8n_tris"])
    assert not rows[:, 3::4].any()
    assert np.array_equal(inst[:, :12].view(np.float32).ravel(), P["p8n_w2o"])
    assert np.array_equal(inst[:, 12], P["p8n_inst_entry"])
    assert not inst[:, 13:].any()
    assert P["stack_cap"] == max(1, min(P["stack_need"], wide.STACK_SIZE))


def _depths(P, kernel):
    """The BFS depth of each record of the packed tree, by its own numbering."""
    if kernel == "K3":
        rec = P["pn_nodes"].reshape(-1, k3.REC)
        return k3.depth_order(SimpleNamespace(
            bvh_ldata=rec[:, 0].astype(np.int64), bvh_rdata=rec[:, 1].astype(np.int64),
            inst_bvh_root=P["pn_roots"],
        ))
    rec = P["p8n_nodes"].reshape(-1, k2.REC)
    entries = rec[:, 48::2].astype(np.int64) | (rec[:, 49::2].astype(np.int64) << 24)
    return k2.wide_depth(
        entries, P["root_entry"] & 0xFFFFFFFF, P["p8n_inst_entry"].astype(np.int64) & 0xFFFFFFFF
    )


@pytest.mark.parametrize("name", SCENES)
def test_k3_buffer_is_k1_layout_over_the_depth_order(compiled, packed, name):
    P = packed[name][0]
    n, t, i = P["num_nodes"], P["num_tris"], P["num_inst"]
    rec, tris, inst = _split(P["k3_words"], [(4, n), (3, t), (4, i)])
    nodes = P["pn_nodes"].reshape(n, k3.REC)
    # ld and rd as int bits where the JAX record holds exact floats
    assert np.array_equal(rec[:, 0], nodes[:, 0].astype(np.int32))
    assert np.array_equal(rec[:, 1], nodes[:, 1].astype(np.int32))
    assert np.array_equal(rec[:, 2:].view(np.float32), nodes[:, 2:])
    rows = tris.view(np.float32)
    assert np.array_equal(rows[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].ravel(), P["pn_tris"])
    assert not rows[:, 3::4].any()
    assert np.array_equal(inst[:, :12].view(np.float32).ravel(), P["pn_w2o"])
    assert np.array_equal(inst[:, 12], P["pn_roots"])
    # the stack the kernel gives a thread: the depth-ordered tree's own need,
    # the same tree as K1's in another numbering
    assert P["stack_need"] == k1.stack_need(compiled[name])
    assert P["stack_cap"] == max(1, min(P["stack_need"], tix.STACK_SIZE))


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("name", SCENES)
def test_staging_rule_and_depth_order(packed, kernel, name):
    P = packed[name][0 if kernel == "K3" else 1]
    words = P["k3_words" if kernel == "K3" else "k2_words"]
    stacks = 4 * P["stack_cap"] * k1.THREADS
    assert P["smem_bytes"] == 16 * (words.size // 4) + stacks
    # the whole buffer beside the stacks: instanced, sphere and the small
    # terrain; the terrain of 20,002 triangles reads it from global memory
    want = "global" if name == "terrain100" else "shared"
    assert P["staging"] == want
    assert (P["smem_bytes"] <= k1.SMEM_BUDGET) == (want == "shared")
    # the records, first in the buffer, are in depth order
    depth = _depths(P, kernel)
    assert (np.diff(depth) >= 0).all()


def test_staging_rule_by_counts():
    # K1's rule for any buffer: the edge of the budget beside a stack of 10
    stacks = 4 * 10 * k1.THREADS
    most = (k1.SMEM_BUDGET - stacks) // 16
    assert k1.staging_words(most, 10) == ("shared", 16 * most + stacks)
    assert k1.staging_words(most + 1, 10) == ("global", 16 * (most + 1) + stacks)
    # and K1's own, by node, triangle and instance counts, is that rule
    assert k1.staging(80, 1284, 3, 8) == k1.staging_words(4 * 80 + 3 * 1284 + 4 * 3, 8)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("name", ["instanced", "terrain100"])
def test_stack_need_bounds_and_per_lane_counts(compiled, packed, kernel, name):
    """The plain version's per-lane counts on seeded rays: they sum to its
    totals, inactive lanes do no work, and no lane's stack holds more than
    the packer's ``stack_need``."""
    host = packed[name][0 if kernel == "K3" else 1]
    P = upload_packed(host, "cpu")
    plain = k3.nodes_plain if kernel == "K3" else k2.wide8_nodes_plain
    rays = _rays(compiled[name], seed=3 + len(name))
    for any_hit in (False, True):
        stats = {"per_lane": True}
        hit = plain(P, *rays, any_hit=any_hit, stats=stats)
        assert hit.mask.any()
        assert int(stats["lane_inner"].sum()) == stats["inner"] > 0
        assert int(stats["lane_tris"].sum()) == stats["tris"] > 0
        assert not stats["lane_inner"][~rays[3]].any()
        assert not stats["lane_tris"][~rays[3]].any()
        assert 1 <= stats["stack_peak"] <= host["stack_need"]
        # and the instrumented run returns the same hits
        again = plain(P, *rays, any_hit=any_hit)
        assert torch.equal(hit.mask, again.mask) and torch.equal(hit.t, again.t)
    ceilings = tix.simt_ceilings(stats["lane_inner"] + stats["lane_tris"], rays[3])
    assert 0 < ceilings["launch_order"] <= 1 and 0 < ceilings["compacted"] <= 1


def test_auto_takes_k1_at_every_size(compiled):
    """'auto' takes the binary kernel K1 at every size, as the docstring of
    ``make_intersectors`` says (on a CPU scene through K1's wrappers, which
    run its plain version); no size threshold is left to send a scene to
    K2."""
    from dataclasses import fields

    from polaris_tpu_torch.scene import upload_scene

    doc = " ".join(tix.make_intersectors.__doc__.split())
    assert "'auto' on a CUDA device 'kernel' at every size" in doc
    assert not hasattr(tix, "AUTO_WIDE_MIN_TRIS")
    for name in ("instanced", "terrain100"):
        scene = compiled[name]
        S = upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")
        closest, _ = tix.make_intersectors(S, mode="auto", tri_test="mt")
        assert "k1_words" in closest.packed and closest.packed["leaf"] == "det2"
