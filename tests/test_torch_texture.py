"""The port's texture sampler and every shading path that reaches it, against
the JAX package's originals, on the CPU.

The JAX package writes its sampler against an array-module argument (``xp``),
so the original runs under plain NumPy. Each test makes its atlases, uvs and
indices from a seed with NumPy and hands the same arrays to both sides.

Tolerances. The bilinear samplers (``tex_sample3``, ``tex_sample1``,
``tex_sample_rgba``, ``mat_sample3``, ``mat_sample1``) must EQUAL the NumPy
evaluation of the original, ``atol=0``: both sides do float32 arithmetic in
the same association, multiply and add rounded separately. The original
fetches one 16-float neighbourhood row per lane where the port gathers the
four corners directly: the same texels. ``tex_bump_sample3`` takes a square
root, which NumPy and PyTorch's CPU kernels implement apart and round one ulp
apart on a few lanes in a thousand: its taps must be equal, its normal agree
within ``BUMP_ATOL = 1.2e-7``, one ulp of a component in ``[0.5, 1]``. The
paths above the sampler (material walk, light sampling,
background) pass through ``normalize``, ``atan2`` and ``acos`` and are held to
``rtol=1e-5, atol=1e-6`` as in tests/test_torch_ops.py.
"""

from dataclasses import fields, replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu.ops import emissive as JE  # noqa: E402
from polaris_tpu.ops import material as JM  # noqa: E402
from polaris_tpu.ops import rng as jrng  # noqa: E402
from polaris_tpu.ops import texture as JT  # noqa: E402
from polaris_tpu.ops.statics import Static as JStatic  # noqa: E402
from polaris_tpu.render import shade as jshade  # noqa: E402
from polaris_tpu_torch.ops import emissive as TE  # noqa: E402
from polaris_tpu_torch.ops import material as TM  # noqa: E402
from polaris_tpu_torch.ops import rng as trng  # noqa: E402
from polaris_tpu_torch.ops import texture as TT  # noqa: E402
from polaris_tpu_torch.ops.statics import Static as TStatic  # noqa: E402
from polaris_tpu_torch.render import shade as tshade  # noqa: E402
from polaris_tpu_torch.scene import upload_scene  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # above the sampler; the samplers themselves: equal
BUMP_ATOL = 1.2e-7  # tex_bump_sample3: one ulp below 1.0 (the square root)
N = 4096
F32 = np.float32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _close(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=label)
    else:
        assert got.dtype == np.float32, (label, got.dtype)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=label)


# ------------------------------------------------------------------ atlases

# name -> [(width, height, store)]: 0 float32 RGBA, 1 Rgba8, 2 Luminance8
ATLASES = {
    "f32": [(5, 3, 0), (1, 1, 0), (8, 8, 0)],
    "rgba8": [(4, 4, 1), (7, 2, 1)],
    "lum8": [(6, 5, 2), (1, 3, 2)],
    "mixed": [(5, 3, 0), (4, 4, 1), (6, 5, 2), (2, 2, 0), (3, 1, 2)],
}


def _atlas(name):
    """(NumPy scene dict, torch scene dict) holding the atlas ``name``."""
    r = np.random.default_rng(sum(map(ord, name)))
    f32, u8, rows = [], [], []
    n_f32 = n_u8 = 0
    for w, h, store in ATLASES[name]:
        if store == 0:
            rows.append((n_f32, w, h, store))
            f32.append(r.uniform(0.0, 4.0, w * h * 4).astype(F32))
            n_f32 += w * h * 4
        else:
            size = w * h * (4 if store == 1 else 1)
            rows.append((n_u8, w, h, store))
            u8.append(r.integers(0, 256, size).astype(np.uint8))
            n_u8 += size
    arrays = {
        "tex_data": np.concatenate(f32) if f32 else np.zeros(0, F32),
        "tex_data_u8": np.concatenate(u8) if u8 else np.zeros(0, np.uint8),
        # the arrays the original's flat-f32 path reads (tex_sample_rgba)
        "tex_offset": np.array([r_[0] for r_ in rows], np.int32),
        "tex_width": np.array([r_[1] for r_ in rows], np.int32),
        "tex_height": np.array([r_[2] for r_ in rows], np.int32),
        "tex_store": np.array([r_[3] for r_ in rows], np.int32),
    }
    S_j = {"_tex_meta": JStatic(tex=tuple(rows)), **arrays}
    S_t = {"_tex_meta": TStatic(tex=tuple(rows)), **{k: _t(v) for k, v in arrays.items()}}
    return S_j, S_t


def _lookups(name, n=N):
    """uv far outside [0, 1), exactly on texel borders and on the last texel's
    edge; indices over every texture, and -1 (no texture) on some lanes."""
    r = np.random.default_rng(len(name))
    n_tex = len(ATLASES[name])
    uv = r.uniform(-2.5, 3.5, (n, 2)).astype(F32)
    edge = np.array(
        [0.0, 1.0, -1.0, 0.5, 0.25, 0.2, 0.99999994, 1.0000001, -0.0, 1e-8, -1e-8,
         0.875, 0.124999994, 2.0 / 3.0, 1.0 / 3.0],
        F32,
    )
    k = edge.size
    uv[: k * k, 0] = np.repeat(edge, k)
    uv[: k * k, 1] = np.tile(edge, k)
    tex_idx = r.integers(-1, n_tex, n).astype(np.int32)
    return uv, tex_idx


@pytest.mark.parametrize("name", sorted(ATLASES))
@pytest.mark.parametrize("fn", ["tex_sample3", "tex_sample1", "tex_bump_sample3"])
def test_sampler_equals_the_numpy_original(name, fn):
    S_j, S_t = _atlas(name)
    uv, tex_idx = _lookups(name)
    want = getattr(JT, fn)(np, S_j, uv, tex_idx)
    got = getattr(TT, fn)(S_t, _t(uv), _t(tex_idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if fn == "tex_bump_sample3":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BUMP_ATOL)
        # what it fetched is equal: the three taps of the footprint
        taps, _, _ = TT._corners(S_t, _t(uv), _t(tex_idx), 1, TT._FOOTPRINT[:3])
        q, _, _ = JT._nb_fetch(np, S_j, uv, tex_idx, S_j["_tex_meta"].tex, nc=1)
        for k, tap in enumerate(taps):
            np.testing.assert_array_equal(tap.numpy()[..., 0], q[..., k])
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all() and want.std() > 0


def test_sampler_takes_the_uploaded_table_and_other_shapes():
    """``upload_scene`` hands the per-texture table over as a tensor; a
    hand-built scene gets one made per call. Both give the same samples, for
    [..., 2] uvs of any leading shape."""
    S_j, S_t = _atlas("mixed")
    uv, tex_idx = _lookups("mixed", 1024)
    with_table = dict(S_t, _tex_table=TT.texture_table(S_t["_tex_meta"].tex, "cpu"))
    want = JT.tex_sample3(np, S_j, uv, tex_idx)
    np.testing.assert_array_equal(TT.tex_sample3(with_table, _t(uv), _t(tex_idx)).numpy(), want)
    got = TT.tex_sample3(S_t, _t(uv.reshape(32, 32, 2)), _t(tex_idx.reshape(32, 32)))
    np.testing.assert_array_equal(got.numpy().reshape(-1, 3), want)


def test_sample_rgba_equals_the_numpy_original():
    """Alpha exists in float storage only: as in the original, a scene with
    byte-stored textures raises."""
    S_j, S_t = _atlas("f32")
    uv, tex_idx = _lookups("f32")
    want = JT.tex_sample_rgba(np, S_j, uv, tex_idx)
    got = TT.tex_sample_rgba(S_t, _t(uv), _t(tex_idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got[..., :3].numpy(), TT.tex_sample3(S_t, _t(uv), _t(tex_idx)).numpy()
    )
    S_j8, S_t8 = _atlas("mixed")
    with pytest.raises(ValueError, match="byte-stored"):
        JT.tex_sample_rgba(np, S_j8, uv, np.zeros_like(tex_idx))
    with pytest.raises(ValueError, match="byte-stored"):
        TT.tex_sample_rgba(S_t8, _t(uv), _t(np.zeros_like(tex_idx)))


def test_edge_texels_clamp_and_bytes_dequantise_after_the_fetch():
    """The arithmetic that must carry over, on values worked out by hand: a
    2x2 Luminance8 texture [[0, 255], [51, 102]]."""
    rows = ((0, 2, 2, 2),)
    S_t = {
        "_tex_meta": TStatic(tex=rows),
        "tex_data": torch.zeros(0),
        "tex_data_u8": torch.tensor([0, 255, 51, 102], dtype=torch.uint8),
    }
    idx = torch.zeros(4, dtype=torch.int32)
    uv = torch.tensor([[0.0, 0.0], [0.25, 0.0], [0.75, 0.0], [0.75, 0.75]])
    got = TT.tex_sample1(S_t, uv, idx).numpy()
    one = F32(255) * F32(1.0 / 255.0)
    # texel centres are not offset: u = 0 is texel 0 exactly, u = 0.25 is half
    # way to texel 1, and from u = 0.5 on the +1 texel is the last one again
    # (clamped, not wrapped to texel 0)
    np.testing.assert_array_equal(got[0], F32(0))
    np.testing.assert_allclose(got[1], 0.5 * one, rtol=1e-7)
    np.testing.assert_array_equal(got[2], one * F32(0.5) + one * F32(0.5))
    want = F32(102) * F32(1.0 / 255.0)
    np.testing.assert_allclose(got[3], want, rtol=1e-6)
    rgb = TT.tex_sample3(S_t, uv, idx).numpy()
    np.testing.assert_array_equal(rgb, np.repeat(got[:, None], 3, axis=1))


def test_gradient_reaches_the_float_atlas():
    """Every read is a differentiable index: d sample / d tex_data is the
    bilinear weight of each corner, and they sum to the sample count."""
    S_j, S_t = _atlas("mixed")
    uv, tex_idx = _lookups("mixed", 512)
    tex_idx = np.where(tex_idx < 0, 0, tex_idx).astype(np.int32)
    data = S_t["tex_data"].clone().requires_grad_(True)
    out = TT.tex_sample3(dict(S_t, tex_data=data), _t(uv), _t(tex_idx))
    out.sum().backward()
    assert data.grad is not None and torch.isfinite(data.grad).all()
    on_f32 = np.isin(tex_idx, [i for i, t in enumerate(ATLASES["mixed"]) if t[2] == 0])
    np.testing.assert_allclose(float(data.grad.sum()), 3.0 * on_f32.sum(), rtol=1e-4)
    assert float(data.grad.reshape(-1, 4)[:, 3].abs().sum()) == 0.0  # alpha is never read


@pytest.mark.parametrize("name", ["f32", "mixed"])
def test_mat_samplers_equal_the_numpy_original(name):
    S_j, S_t = _atlas(name)
    uv, tex_idx = _lookups(name)
    r = np.random.default_rng(3)
    d3 = r.uniform(0, 1, (N, 3)).astype(F32)
    d1 = r.uniform(0, 1, N).astype(F32)
    stx = dict(tex_fields=frozenset({"reflectance"}))
    S_j = dict(S_j, _stx=JStatic(**stx))
    S_t = dict(S_t, _stx=TStatic(**stx))
    for field in (None, "reflectance"):
        want3 = JT.mat_sample3(np, S_j, uv, d3, tex_idx, field)
        got3 = TT.mat_sample3(S_t, _t(uv), _t(d3), _t(tex_idx), field)
        np.testing.assert_array_equal(got3.numpy(), want3)
        want1 = JT.mat_sample1(np, S_j, uv, d1, tex_idx, field)
        got1 = TT.mat_sample1(S_t, _t(uv), _t(d1), _t(tex_idx), field)
        np.testing.assert_array_equal(got1.numpy(), want1)
    # lanes without a texture keep their constant, the others do not
    off = tex_idx < 0
    np.testing.assert_array_equal(got3.numpy()[off], d3[off])
    assert (got3.numpy()[~off] != d3[~off]).any()
    # a field the host proved texture-free hands the constant back untouched
    np.testing.assert_array_equal(
        TT.mat_sample3(S_t, _t(uv), _t(d3), _t(tex_idx), "radiance").numpy(), d3
    )
    np.testing.assert_array_equal(
        TT.mat_sample1(S_t, _t(uv), _t(d1), _t(tex_idx), "roughness").numpy(), d1
    )


# ------------------------------------------------------------ material walk


def _map_tree():
    """A synthetic tree holding all three texture operators:
    normalMap(bumpMap(mixMap(diffuse, conductor, lum8 texture), f32 texture),
    rgba8 texture); children before parents, as the compiler emits them."""
    S_j, S_t = _atlas("mixed")
    n_nodes = 5
    r = np.random.default_rng(21)
    neg = np.full(n_nodes, -1, np.int32)
    arrays = {
        "mat_type": np.array(
            [2, 4, JM.OP_MIX_MAP, JM.OP_BUMP_MAP, JM.OP_NORMAL_MAP], np.int32
        ),
        "mat_left": np.array([-1, -1, 0, 2, 3], np.int32),
        "mat_right": np.array([-1, -1, 1, -1, -1], np.int32),
        "mat_mix_weight": np.full(n_nodes, 0.5, F32),
        # textures 2 (Luminance8), 0 (float32), 1 (Rgba8) of the mixed atlas
        "mat_bump_tex": np.array([-1, -1, 2, 0, 1], np.int32),
        "mat_int_disp_ior": np.zeros((n_nodes, 3), F32),
        "mat_ext_disp_ior": np.zeros((n_nodes, 3), F32),
    }
    for f in JM.MATERIAL_FIELDS:
        if f == "type":
            continue
        if f.endswith("_tex"):
            arrays["mat_" + f] = neg
        elif f in ("int_ior", "ext_ior", "scale", "roughness"):
            arrays["mat_" + f] = r.uniform(0.1, 2.0, n_nodes).astype(F32)
        else:
            arrays["mat_" + f] = r.uniform(0, 1, (n_nodes, 3)).astype(F32)
    stx = dict(
        tex_fields=frozenset(), ops=frozenset({"mixmap", "bump", "normal"}),
        bxdf_types=frozenset({2, 4}), lights=frozenset({"area"}), bg_tex=False,
    )
    S_j = dict(S_j, _stx=JStatic(**stx), **arrays)
    S_t = dict(S_t, _stx=TStatic(**stx), **{k: _t(v) for k, v in arrays.items()})
    return S_j, S_t, arrays


def test_material_walk_with_texture_operators_matches_jax():
    S_j, S_t, arrays = _map_tree()
    assert TM.MATERIAL_FIELDS == JM.MATERIAL_FIELDS
    depth = JM.material_tree_depth(arrays["mat_type"], arrays["mat_left"], arrays["mat_right"])
    assert depth == 3 == TM.material_tree_depth(
        arrays["mat_type"], arrays["mat_left"], arrays["mat_right"]
    )
    n = 2048
    r = np.random.default_rng(22)
    v = r.normal(size=(n, 3))
    normal = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F32)
    uv = r.uniform(-1, 2, (n, 2)).astype(F32)
    root = np.full(n, 4, np.int32)
    pix = np.arange(n, dtype=np.int64)
    U_j = jrng.make_uniform(jrng.np_uniform, 1, pix.astype(np.uint32), 2, 1)
    U_t = trng.make_uniform(1, _t(pix), 2, 1)
    mat_j, normal_j, tint_j, flags_j = JM.select_material(
        np, S_j, U_j, root, normal, uv, np.zeros(n, np.uint32), max_depth=depth
    )
    mat_t, normal_t, tint_t, flags_t = TM.select_material(
        S_t, U_t, _t(root), _t(normal), _t(uv), torch.zeros(n, dtype=torch.int32),
        max_depth=depth,
    )
    assert set(mat_t) == set(mat_j)
    for k in mat_j:
        _close(mat_t[k], mat_j[k], k)
    _close(normal_t, normal_j, "normal")
    _close(tint_t, tint_j, "tint")
    _close(flags_t, flags_j, "flags")
    # the maps bite: both leaves are reached, by a weight that follows the
    # texture, and the normal is perturbed and stays a unit vector
    types = mat_t["type"].numpy()
    assert 0.1 < (types == 2).mean() < 0.9 and set(np.unique(types)) == {2, 4}
    assert np.abs(normal_t.numpy() - normal).max() > 1e-2
    np.testing.assert_allclose(np.linalg.norm(normal_t.numpy(), axis=-1), 1.0, atol=1e-5)
    w = TT.tex_sample1(S_t, _t(uv), torch.full((n,), 2, dtype=torch.int32)).numpy()
    draw = U_t(trng.STREAM_MAT_MIX + 2).numpy()  # the mixMap sits at level 2
    np.testing.assert_array_equal(types == 2, draw < w)


# ------------------------------------------- textured lights and background


@pytest.fixture(scope="module")
def dispersive(scenes_dir, sphere_scene):
    """The dispersive scene (a float-stored 128x64 lat-long map behind the
    environment light and the background), and the sphere scene with that
    map as the radiance of its area light."""
    import os

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    scene = compile_scene(read_scene(os.path.join(scenes_dir, "dispersive.obj")))
    env_tex = int(scene.mat_reflectance_tex[scene.scene_diffuse_mat])
    assert env_tex >= 0 and scene.tex_store[env_tex] == 0
    radiance_tex = sphere_scene.mat_radiance_tex.copy()
    radiance_tex[sphere_scene.emis_mat] = env_tex
    # give the light's triangles uvs that spread over the map
    uvs = sphere_scene.tri_uvs.copy()
    r = np.random.default_rng(31)
    uvs[sphere_scene.emis_tri] = r.uniform(
        0, 1, uvs[sphere_scene.emis_tri].shape
    ).astype(F32)
    lit = replace(
        sphere_scene, mat_radiance_tex=radiance_tex, tri_uvs=uvs,
        tex_data=scene.tex_data, tex_offset=scene.tex_offset,
        tex_width=scene.tex_width, tex_height=scene.tex_height,
        tex_store=scene.tex_store, tex_data_u8=scene.tex_data_u8,
    )
    return scene, lit


def _dicts(scene):
    geom, params = scene.split_params()
    S_t = upload_scene({f.name: getattr(scene, f.name) for f in fields(scene)}, "cpu")
    return {**geom, **params}, S_t


def test_textured_area_and_environment_lights_match_jax(dispersive):
    scene, lit = dispersive
    assert set(scene.emis_type) == {1} and set(lit.emis_type) == {0}  # sky; area
    for label, sc in (("environment light", scene), ("area light", lit)):
        S_j, S_t = _dicts(sc)
        assert "radiance" in S_t["_stx"].tex_fields
        r = np.random.default_rng(32)
        lo, hi = sc.bvh_min[0], sc.bvh_max[0]
        point = (lo + r.uniform(0.05, 0.95, (N, 3)) * (hi - lo)).astype(F32)
        v = r.normal(size=(N, 3))
        normal = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F32)
        l_idx = r.integers(0, sc.emis_area.shape[0], N).astype(np.int32)
        u1 = r.uniform(0.01, 0.99, N).astype(F32)
        u2 = r.uniform(0.01, 0.99, N).astype(F32)
        want = JE.emissive_sample(np, S_j, point, normal, l_idx, u1, u2)
        got = TE.emissive_sample(S_t, _t(point), _t(normal), _t(l_idx), _t(u1), _t(u2))
        for g, w, name in zip(got, want, ("value", "dir", "pdf", "dist")):
            _close(g, w, f"{label}/{name}")
        # the map's texels differ, so sampled radiance varies over the lanes
        seen = got[0].numpy()[got[2].numpy() > 0]
        seen = seen[seen.sum(axis=-1) > 0]
        assert len(seen) > 100
        ratio = seen[:, 0] / seen.sum(axis=-1)  # colour, whatever the geometry term
        assert len(np.unique(ratio.round(3))) > 10


@pytest.mark.parametrize("is_primary", [True, False, "lanes"], ids=["primary", "indirect", "per-lane"])
def test_textured_background_matches_jax(dispersive, is_primary):
    scene, _ = dispersive
    S_j, S_t = _dicts(scene)
    assert S_t["_stx"].bg_tex
    r = np.random.default_rng(33)
    v = r.normal(size=(N, 3))
    d = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F32)
    d[:6] = np.array(  # the poles and the seam of the lat-long map
        [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0]], F32
    )
    throughput = r.uniform(0, 1.5, (N, 3)).astype(F32)
    if is_primary == "lanes":
        prim = (r.uniform(size=N) < 0.5)[:, None]
        prim_j, prim_t = prim, _t(prim)
    else:
        prim_j = prim_t = is_primary
    bg = int(scene.scene_diffuse_mat)
    want = jshade.shade_miss(np, S_j, d, throughput, prim_j, bg)
    got = tshade.shade_miss(S_t, _t(d), _t(throughput), prim_t, bg)
    _close(got, want, "background")
    assert got.numpy().std(axis=0).min() > 0  # a map, not a constant
