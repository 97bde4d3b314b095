"""The port's leaf tests against the TPU kernels' own arithmetic, on the CPU.

The kernels of ``polaris_tpu_torch`` carry three leaf tests, each mirrored by
a plain PyTorch version in ``ops/intersect.py``: ``mt_block`` (quotient form;
the 8-wide TPU kernel with resident nodes and the JAX package's non-Pallas
traversals), ``mt_block_det2`` (det²-scaled Möller–Trumbore; the TPU kernels
K1, K2, K3, K5) and ``hh_block`` (Havel–Herout planes; K1 with
``POLARIS_TRI_TEST=hh``). The CUDA kernels only run on a card, where
``chip_smoke.py`` holds each against its plain version bit for bit. Here the
plain versions of the two scaled forms are held against

  * the TPU kernel itself in Pallas interpret mode, on one 16,384-ray block of
    cornell primaries: one closest-hit and one any-hit call per form, the
    second form with ``POLARIS_TRI_TEST=hh`` set around ``pack_scene`` as the
    JAX package's own tests run it
  * the JAX packer: ``pack_tris_hh`` must be ``np.array_equal`` to
    ``_pack_tris_hh``
  * a NumPy transcription of the kernel body's triangle loop, on random
    triangle blocks (every lane, no traversal in the way), where they must be
    EQUAL: NumPy and PyTorch both round each multiply and add on its own
  * each other: K3's plain version equals K1's on every field of every lane

Tolerances against the Pallas kernel, on lanes that report the same triangle:
``t`` within ``rtol=1e-5, atol=1e-6``; ``u, v`` within ``UV_ATOL = 5e-6``
(measured: at most 1.7e-6). While the port ran one quotient-form test against
these det²-scaled kernels that bound stood at ``1e-4``. What is left is not
the algebraic form, which is now the same: XLA contracts multiply-add pairs
into FMAs on the CPU where PyTorch rounds each product (K4, quotient form on
both sides, shows the same 1.6e-6 in tests/test_torch_traversal_modes.py).
Mask / tri / inst must be equal but for ties, counted against
``MAX_TIE_SHARE``.
"""

import os
from dataclasses import fields

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polaris_tpu_torch.ops import intersect as tix  # noqa: E402
from polaris_tpu_torch.ops import intersect_cuda, intersect_nodes  # noqa: E402
from polaris_tpu_torch.ops._launch import upload_packed  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402
from test_torch_intersect import (  # noqa: E402
    _hit_to_numpy,
    _primary_rays,
    _seeded_rays,
    _torch_hit_to_numpy,
)

FLT_MAX = np.float32(3.4028235e38)
RTOL, ATOL = 1e-5, 1e-6  # t
UV_ATOL = 5e-6  # u, v against the Pallas kernel (see the module docstring)
MAX_TIE_SHARE = 2e-3
EPS = 1e-5
F32 = np.float32


@pytest.fixture(scope="module")
def cornell(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    scene = compile_scene(read_scene(os.path.join(scenes_dir, "cornell.obj")))
    S_t = upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")
    return scene, S_t


@pytest.fixture(scope="module")
def batch(cornell):
    """One BLOCK_RAYS batch of cornell primaries; the any-hit call gives every
    second lane a short ``maxt``; some lanes are switched off."""
    from polaris_tpu.ops.intersect_pallas import BLOCK_RAYS

    scene, _ = cornell
    o, d = _primary_rays(scene, 128, 128, seed=9)
    assert o.shape[0] == BLOCK_RAYS
    r = np.random.default_rng(13)
    maxt_any = np.where(
        np.arange(BLOCK_RAYS) % 2 == 0, r.uniform(0.5, 6.0, BLOCK_RAYS), FLT_MAX
    ).astype(F32)
    active = r.uniform(size=BLOCK_RAYS) > 0.05
    return o, d, maxt_any, active


# ------------------------------------------------- the Pallas kernel itself


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tri_test", ["mt", "hh"])
def test_plain_version_matches_the_pallas_kernel(cornell, batch, monkeypatch, tri_test, any_hit):
    from polaris_tpu.ops.intersect_pallas import intersect_pallas, pack_scene

    scene, S_t = cornell
    o, d, maxt_any, active = batch
    maxt = maxt_any if any_hit else np.full(o.shape[0], FLT_MAX, F32)
    monkeypatch.setenv("POLARIS_TRI_TEST", tri_test)
    P = pack_scene(scene)
    assert bool(P["pk_hh"]) == (tri_test == "hh")
    P = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in P.items()}
    ref = _hit_to_numpy(
        intersect_pallas(P, *(jnp.asarray(x) for x in (o, d, maxt, active)), any_hit=any_hit)
    )
    # tri_test=None: the port reads the same variable when it packs
    closest, occluded = tix.make_intersectors(S_t, "pallas_stream")
    assert hasattr(closest, "tris_hh") == (tri_test == "hh")
    rays = tuple(torch.from_numpy(x) for x in (o, d, maxt, active))
    n = o.shape[0]
    if any_hit:
        got = occluded(S_t, *rays).numpy()
        assert not got[~active].any()
        n_odd = int((got != ref["mask"]).sum())
        print(f"{tri_test}/any: {n_odd} of {n} occlusion lanes differ")
        assert n_odd <= int(MAX_TIE_SHARE * n)
        assert got.any() and (~got[active]).any()
        return
    got = _torch_hit_to_numpy(closest(S_t, *rays))
    assert not got["mask"][~active].any() and (got["t"][~got["mask"]] == 0).all()
    both = got["mask"] & ref["mask"]
    same = both & (got["tri"] == ref["tri"]) & (got["inst"] == ref["inst"])
    n_odd = int(((got["mask"] != ref["mask"]) | (both & ~same)).sum())
    print(f"{tri_test}/closest: {n_odd} of {n} lanes differ in mask/tri/inst; "
          f"{int(both.sum())} hits")
    assert n_odd <= int(MAX_TIE_SHARE * n) and both.sum() > 0.3 * n
    np.testing.assert_allclose(got["t"][same], ref["t"][same], rtol=RTOL, atol=ATOL)
    for k in ("u", "v"):
        diff = np.abs(got[k][same] - ref[k][same])
        print(f"{tri_test}/closest/{k}: max abs diff {float(diff.max()):.2e} "
              f"(bound {UV_ATOL})")
        assert float(diff.max()) <= UV_ATOL, k


def test_pack_tris_hh_equals_the_jax_packer(cornell, scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.procedural import make_terrain_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.ops.intersect_pallas import _pack_tris_hh

    scenes = [cornell[0], compile_scene(make_terrain_scene(grid=16))]
    scenes.append(compile_scene(read_scene(os.path.join(scenes_dir, "instanced.obj"))))
    for scene in scenes:
        want = _pack_tris_hh(scene)
        got = tix.pack_tris_hh(scene)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == (12 * scene.tri_v0.shape[0],)
        assert np.array_equal(got, want)
    # a degenerate triangle packs to finite rows (|N|^2 floored), as there
    class Flat:
        tri_v0 = np.array([[1.0, 2.0, 3.0]], F32)
        tri_e1 = np.array([[1.0, 0.0, 0.0]], F32)
        tri_e2 = np.array([[2.0, 0.0, 0.0]], F32)

    assert np.array_equal(tix.pack_tris_hh(Flat), _pack_tris_hh(Flat))
    assert np.isfinite(tix.pack_tris_hh(Flat)).all()
    # the uploaded scene's own arrays give the same rows
    rows = intersect_cuda.intersectors(cornell[1], "hh")[0].tris_hh
    assert np.array_equal(rows.numpy(), _pack_tris_hh(cornell[0]))


# ------------------------------------ the kernel body's loop, transcribed


def _numpy_scan(form, tris, tri, valid, o, d, best_t, closest, carry=None):
    """The triangle loop of ``intersect_pallas._kernel`` (``mt_tests`` /
    ``hh_tests``, ``tier_closest`` / ``tier_any``) written out in NumPy
    float32, one column of the block after the other. ``carry`` is the best
    hit so far as ``(t_num, den, u_num, v_num, tri)``; without it a leaf
    starts at ``(best_t, 1, 0, 0, -1)``. Returns which lanes accepted a
    triangle, the best hit in the same form, and the first accepted triangle."""
    m, width = tri.shape
    px, py, pz = (o[:, k] for k in range(3))
    qx, qy, qz = (d[:, k] for k in range(3))
    eps = F32(EPS)
    eps2 = F32(EPS * EPS)
    if carry is None:
        carry = (best_t, np.ones(m, F32), np.zeros(m, F32), np.zeros(m, F32),
                 np.full(m, -1, np.int64))
    bt_num, bt_den, bu, bv, btri = (x.copy() for x in carry)
    found = np.zeros(m, bool)
    first = np.full(m, -1, np.int64)
    for j in range(width):
        row = tris[tri[:, j]]
        if form == "hh":
            nx, ny, nz, d0, n1x, n1y, n1z, d1, n2x, n2y, n2z, d2 = row.T
            det = qx * nx + qy * ny + qz * nz
            t_raw = d0 - (px * nx + py * ny + pz * nz)
            det_a = det * det
            ok = det_a >= eps2
            hx = det * px + t_raw * qx
            hy = det * py + t_raw * qy
            hz = det * pz + t_raw * qz
            u_num = (n1x * hx + n1y * hy + n1z * hz + det * d1) * det
            v_num = (n2x * hx + n2y * hy + n2z * hz + det * d2) * det
            ok &= (u_num >= 0.0) & (v_num >= 0.0) & (u_num + v_num <= det_a)
            t_num = t_raw * det
            ok &= t_num > eps * det_a
        else:
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.T
            pvx = qy * e2z - qz * e2y
            pvy = qz * e2x - qx * e2z
            pvz = qx * e2y - qy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_a = det * det
            ok = det_a >= eps2
            tvx, tvy, tvz = px - v0x, py - v0y, pz - v0z
            u_num = (tvx * pvx + tvy * pvy + tvz * pvz) * det
            ok &= (u_num >= 0.0) & (u_num <= det_a)
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v_num = (qx * qvx + qy * qvy + qz * qvz) * det
            ok &= (v_num >= 0.0) & (u_num + v_num <= det_a)
            t_num = (e2x * qvx + e2y * qvy + e2z * qvz) * det
            ok &= t_num > eps * det_a
        with np.errstate(over="ignore"):  # FLT_MAX * det_a is +inf, on purpose
            if closest:
                ok &= t_num * bt_den < bt_num * det_a
            else:
                ok &= t_num < best_t * det_a
        ok &= valid[:, j]
        if closest:
            bt_num = np.where(ok, t_num, bt_num)
            bt_den = np.where(ok, det_a, bt_den)
            bu = np.where(ok, u_num, bu)
            bv = np.where(ok, v_num, bv)
            btri = np.where(ok, tri[:, j], btri)
        first = np.where(ok & ~found, tri[:, j], first)
        found |= ok
    return found, (bt_num, bt_den, bu, bv, btri), first


def _numpy_leaf(form, tris, tri, valid, o, d, best_t, closest):
    """One leaf visit of the BVH kernels: the loop, then the divide at leaf
    exit."""
    found, (bt_num, bt_den, bu, bv, btri), first = _numpy_scan(
        form, tris, tri, valid, o, d, best_t, closest
    )
    inv = F32(1.0) / bt_den
    return found, bt_num * inv, bu * inv, bv * inv, btri, first


def _random_blocks(seed, m=3000, width=11, num_tris=200):
    """Rays aimed at a point inside one triangle of their block, so that most
    lanes hit one and many hit several; some aimed along an edge."""
    r = np.random.default_rng(seed)
    v0 = r.uniform(-1, 1, (num_tris, 3))
    e1 = r.normal(size=(num_tris, 3)) * r.uniform(0.05, 1.5, (num_tris, 1))
    e2 = r.normal(size=(num_tris, 3)) * r.uniform(0.05, 1.5, (num_tris, 1))
    e2[:5] = e1[:5] * 2.0  # degenerate triangles
    v0, e1, e2 = (x.astype(F32) for x in (v0, e1, e2))
    tri = r.integers(0, num_tris, (m, width))
    valid = np.arange(width)[None, :] < r.integers(1, width + 1, m)[:, None]
    aim = tri[np.arange(m), r.integers(0, width, m)]
    bu = r.uniform(0, 1, m)
    bv = r.uniform(0, 1, m) * (1 - bu)
    bu[: m // 10] = 0.0  # on the edge v0 - (v0 + e2)
    target = v0[aim] + bu[:, None] * e1[aim] + bv[:, None] * e2[aim]
    o = r.uniform(-3, 3, (m, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    best_t = np.where(r.uniform(size=m) < 0.5, FLT_MAX, r.uniform(0.5, 6.0, m)).astype(F32)
    return (v0, e1, e2), tri, valid, o.astype(F32), d.astype(F32), best_t


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
@pytest.mark.parametrize("form", ["det2", "hh"])
def test_block_test_equals_the_kernel_bodys_loop(form, closest):
    (v0, e1, e2), tri, valid, o, d, best_t = _random_blocks(41)
    if form == "hh":
        class Tris:
            tri_v0, tri_e1, tri_e2 = v0, e1, e2

        rows = tix.pack_tris_hh(Tris).reshape(-1, 12)
        T = tix.HHRows(torch.from_numpy(rows))
        block = tix.hh_block
    else:
        rows = np.concatenate([v0, e1, e2], axis=1)
        T = tix.TriArrays(*(torch.from_numpy(x) for x in (v0, e1, e2)))
        block = tix.mt_block_det2
    found, t, u, v, btri, first = _numpy_leaf(form, rows, tri, valid, o, d, best_t, closest)
    hit, bt, bu, bv, btri_t = block(
        T, torch.from_numpy(tri), torch.from_numpy(valid), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(best_t), closest=closest,
    )
    np.testing.assert_array_equal(hit.numpy(), found)
    assert 0.4 * len(found) < found.sum() < len(found)
    if not closest:
        assert bt is None and bu is None and bv is None
        np.testing.assert_array_equal(btri_t.numpy()[found], first[found])
        return
    np.testing.assert_array_equal(btri_t.numpy()[found], btri[found])
    for got, want in ((bt, t), (bu, u), (bv, v)):
        np.testing.assert_array_equal(got.numpy()[found], want[found])
    # a lane that accepted nothing hands its best back unchanged: x * (1/1)
    np.testing.assert_array_equal(bt.numpy()[~found], best_t[~found])
    # several candidates per lane: the sequential compare was really at work
    later = (btri != first) & found
    assert later.sum() > 0.05 * found.sum()


def test_scaled_and_quotient_forms_agree_to_a_few_ulps():
    """The three forms are one test in exact arithmetic. On random blocks
    (slivers and grazing rays among them, which real scenes' rays rarely meet)
    they pick the same triangle on all but a few edge lanes, and ``t, u, v``
    agree within 1e-5 on 97% of the lanes and within 1e-3 on all of them (the
    error of a barycentric scales with ``|o - v0| * |d x e2| / |det|``)."""
    (v0, e1, e2), tri, valid, o, d, best_t = _random_blocks(43)

    class Tris:
        tri_v0, tri_e1, tri_e2 = v0, e1, e2

    T = tix.TriArrays(*(torch.from_numpy(x) for x in (v0, e1, e2)))
    H = tix.HHRows(torch.from_numpy(tix.pack_tris_hh(Tris).reshape(-1, 12)))
    args = tuple(torch.from_numpy(x) for x in (tri, valid, o, d, best_t))
    out = {
        "quot": tix.mt_block(T, *args, closest=True),
        "det2": tix.mt_block_det2(T, *args, closest=True),
        "hh": tix.hh_block(H, *args, closest=True),
    }
    base = out["det2"]
    for form in ("quot", "hh"):
        hit, bt, bu, bv, btri = out[form]
        both = (hit & base[0]).numpy()
        same = both & (btri == base[4]).numpy()
        odd = int((hit != base[0]).sum()) + int((both & ~same).sum())
        print(f"{form} against det2: {odd} of {len(both)} lanes differ")
        assert odd <= 0.02 * len(both)
        for got, want in ((bt, base[1]), (bu, base[2]), (bv, base[3])):
            diff = np.abs(got.numpy()[same] - want.numpy()[same])
            diff = diff / np.maximum(np.abs(want.numpy()[same]), 1.0)
            assert (diff > 1e-5).mean() <= 0.03 and diff.max() <= 1e-3


# ----------------------------------------------------- K3 = K1, bit for bit


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_k3_equals_k1_bit_for_bit(cornell, any_hit):
    """The TPU kernels' contract (``intersect_pallas_nodes.py``: bit-exact
    with the binary kernel), kept by the plain versions: every field of every
    lane, on seeded rays of every kind."""
    scene, S_t = cornell
    rays = tuple(torch.from_numpy(x) for x in _seeded_rays(scene, seed=51))
    P = upload_packed(intersect_nodes.pack_scene_nodes(scene), "cpu")
    P1 = intersect_cuda.intersectors(S_t, "mt")[0].packed
    if any_hit:
        k1 = intersect_cuda.any_hit(P1, *rays)
        k3 = intersect_nodes.any_hit(P, *rays)
        assert torch.equal(k1, k3) and k1.any() and not k1.all()
        return
    k1 = intersect_cuda.closest_hit(P1, *rays)
    k3 = intersect_nodes.closest_hit(P, *rays)
    for f in k1._fields:
        assert torch.equal(getattr(k1, f), getattr(k3, f)), f
    assert k1.mask.sum() > 0.3 * k1.mask.shape[0]
    # and neither is the quotient form in disguise
    quot = tix.intersect_bvh(S_t, *rays, any_hit=False, leaf="quot")
    assert not torch.equal(quot.u, k1.u)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_dense_plain_equals_the_dense_kernel_bodys_loop(cornell, monkeypatch, any_hit):
    """The loop of ``intersect_pallas_dense._kernel`` transcribed in NumPy:
    every instance in order, the ray moved into its space once, every
    triangle of its range in order, the best hit kept as numerators over ONE
    denominator across all of them and divided once per ray. ``dense_plain``
    must return the same bits, whatever the width of its chunks."""
    from polaris_tpu_torch.ops import intersect_dense

    scene, _ = cornell
    o, d, maxt, active = _seeded_rays(scene, seed=52)
    rays = tuple(torch.from_numpy(x) for x in (o, d, maxt, active))
    host = intersect_dense.pack_scene_dense(scene)
    P = upload_packed(host, "cpu")
    n = o.shape[0]
    rows = host["pk_tris"].reshape(-1, 9)
    best_t = np.where(active, maxt, F32(0.0)).astype(F32)
    carry = (best_t, np.ones(n, F32), np.zeros(n, F32), np.zeros(n, F32),
             np.zeros(n, np.int64))
    found, inst = np.zeros(n, bool), np.zeros(n, np.int32)
    ranges = host["pk_ranges"].reshape(-1, 2)
    assert len(ranges) > 1  # the denominator really crosses instances
    for ii, (first, count) in enumerate(ranges):
        m = P["pk_w2o"].reshape(-1, 3, 4)[ii : ii + 1].expand(n, 3, 4)
        io, idr = tix._xform(m, rays[0], 1).numpy(), tix._xform(m, rays[1], 0).numpy()
        tri = np.broadcast_to(np.arange(first, first + count), (n, count))
        hit, new, _ = _numpy_scan(
            "det2", rows, tri, np.ones((n, count), bool), io, idr, best_t,
            closest=not any_hit, carry=carry,
        )
        if any_hit:
            hit &= ~found  # a ray stops at its first hit
        else:
            carry = new
            inst = np.where(hit, np.int32(ii), inst)
        found |= hit
    inv = F32(1.0) / carry[1]
    want = {
        "t": np.where(found, carry[0] * inv, F32(0.0)), "u": carry[2] * inv,
        "v": carry[3] * inv, "tri": carry[4].astype(np.int32), "inst": inst,
        "mask": found & active,
    }
    assert 0.3 * n < found.sum() < n
    for pairs in (None, 5 * n):  # the default chunk, and chunks of 5 triangles
        if pairs:
            monkeypatch.setattr(intersect_dense, "_PAIRS_PER_STEP", pairs)
        got = intersect_dense.dense_plain(P, *rays, any_hit=any_hit)
        np.testing.assert_array_equal(got.mask.numpy(), want["mask"])
        if not any_hit:
            for k, v in _torch_hit_to_numpy(got).items():
                np.testing.assert_array_equal(v, want[k], err_msg=f"{k}, chunks of {pairs}")
