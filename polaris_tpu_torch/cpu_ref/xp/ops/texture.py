"""Backend-generic texture sampling from the flat float32 RGBA atlas.

Counterpart of the reference's manual global-memory texture fetch
(``CL/samplers/texture_sampler.cl:14-252``): repeat wrap, bilinear filtering,
plus the 3-tap bump-to-normal reconstruction. Because the compile-time loader
normalizes every texture to float32 RGBA (asset/texture.py), the four-format
switch disappears — sampling is a pure gather + lerp, differentiable w.r.t.
the atlas.

TPU redesign (round 3): per-lane gathers cost ~1 element-lookup per cycle on
the TPU, and the naive bilinear fetch needed SEVEN of them per lane — four
(1,4) corner rows plus three table lookups (offset/width/height). Measured
end-to-end (ATTRIB_r03.json, statics-forced so the workload is bit-identical)
that machinery alone cost +50% frame time on the sphere config and explained
most of the mitsuba/dispersive deficit. The fetch is now ONE contiguous
16-float lookup from a neighborhood atlas — each texel stores its full 2x2
bilinear footprint [tl, tr, bl, br] with the edge clamp baked in — built
INSIDE the program from ``tex_data`` with static-shape ops, so it hoists out
of the bounce loop, costs nothing per bounce, and gradients still flow to the
original atlas. Table metadata rides as a host-static sidecar
(scene_data.split_params ``_tex_meta``), so offset/width/height resolve as
where-select chains (vec.take_small), not gathers.

The scene dict ``S`` must contain tex_data (K,) and, for the fast path, the
``_tex_meta`` static; tex_offset/width/height arrays remain for consumers
that build S by hand (the old 7-lookup path is kept as their fallback).
"""

from __future__ import annotations

import numpy as np

from . import vec as V


def _meta(S):
    m = S.get("_tex_meta")
    if m is None:
        return None
    rows = m.tex
    return rows if rows else None


def _nb_one(xp, S, off, w, h, store, nc):
    """One texture's (h*w, 4*nc) neighborhood rows in its NATIVE dtype."""
    if store == 0:
        t = S["tex_data"][off : off + w * h * 4].reshape(h, w, 4)[..., :nc]
    elif store == 1:  # Rgba8: interleaved bytes, dequantized post-gather
        t = S["tex_data_u8"][off : off + w * h * 4].reshape(h, w, 4)[..., :nc]
    else:  # Luminance8: single channel, replicated like the f32 loader did
        t = S["tex_data_u8"][off : off + w * h].reshape(h, w, 1)
        if nc > 1:
            t = xp.broadcast_to(t, (h, w, nc))
    xi = np.minimum(np.arange(w) + 1, w - 1)
    yi = np.minimum(np.arange(h) + 1, h - 1)
    tr = t[:, xi]
    b = t[yi]
    return xp.concatenate([t, tr, b, b[:, xi]], axis=-1).reshape(w * h, 4 * nc)


def _nb_atlas(xp, S, rows, nc):
    """Per-storage-family neighborhood atlases: texel (y, x) holds the four
    corners [t(y,x), t(y,bx), t(by,x), t(by,bx)] — ``nc`` components each
    (3 = RGB bilinear, 1 = red-channel / bump taps; alpha is never sampled
    by any consumer, and the per-lane lookup cost is per ELEMENT, so smaller
    rows are proportionally cheaper) — with bx/by clamped at the edge (the
    reference clamps rather than wraps the +1 texel,
    texture_sampler.cl:124-141). Built from the atlases with static-index
    ops only — differentiable (f32 family), loop-invariant, identical in
    jax/numpy. Byte textures (texture_fmt.go Luminance8/Rgba8) KEEP their
    u8 dtype through the neighborhood table and the per-lane gather —
    dequantization happens after the 4*nc-element fetch — so their HBM
    footprint stays 4x smaller end to end.

    Returns (nb_f32 or None, nb_u8 or None)."""
    parts = {0: [], 1: []}
    for off, w, h, store in rows:
        parts[0 if store == 0 else 1].append(
            _nb_one(xp, S, off, w, h, store, nc)
        )

    def cat(ps):
        if not ps:
            return None
        return xp.concatenate(ps, axis=0) if len(ps) > 1 else ps[0]

    return cat(parts[0]), cat(parts[1])


def _nb_fetch(xp, S, uv, tex_idx, rows, nc=3):
    """uv -> (corners (N,4*nc) f32, cx, cy) via one contiguous lookup per
    storage family present (one for all-f32 or all-byte scenes)."""
    offs = {0: 0, 1: 0}
    tab = []
    for off, w, h, store in rows:
        fam = 0 if store == 0 else 1
        tab.append((offs[fam], w, h, fam))
        offs[fam] += w * h
    tab = np.asarray(tab, np.int32)
    safe_idx = xp.maximum(tex_idx, 0)
    row = V.take_small(xp, xp.asarray(tab), safe_idx)  # (N, 4) where-selects
    off = row[..., 0]
    w = row[..., 1]
    h = row[..., 2]
    fam = row[..., 3]
    wf = w.astype(uv.dtype)
    hf = h.astype(uv.dtype)
    su = (uv[..., 0] - xp.floor(uv[..., 0])) * wf
    sv = (uv[..., 1] - xp.floor(uv[..., 1])) * hf
    tx = xp.clip(su.astype(w.dtype), 0, w - 1)
    ty = xp.clip(sv.astype(h.dtype), 0, h - 1)
    cx = su - tx.astype(uv.dtype)
    cy = sv - ty.astype(uv.dtype)
    nb_f, nb_u = _nb_atlas(xp, S, rows, nc)
    idx = off + ty * w + tx

    def dequant(q):
        # the loader's exact multiply (asset/texture.py INV255): byte and
        # float storage produce bit-identical samples in both backends
        return q.astype(uv.dtype) * np.float32(1.0 / 255.0)

    if nb_u is None:
        q = nb_f[idx]
    elif nb_f is None:
        q = dequant(nb_u[idx])
    else:  # mixed scene: one gather per family, lanes pick theirs
        qf = nb_f[xp.clip(idx, 0, nb_f.shape[0] - 1)]
        qu = dequant(nb_u[xp.clip(idx, 0, nb_u.shape[0] - 1)])
        q = xp.where((fam == 1)[..., None], qu, qf)
    return q, cx, cy


def tex_sample_rgba(xp, S, uv, tex_idx):
    """Bilinear RGBA sample (fallback-path consumers only — the fast path
    serves RGB/R directly since nothing samples alpha)."""
    return _tex_sample_rgba_slow(xp, S, uv, tex_idx)


def tex_sample3(xp, S, uv, tex_idx):
    rows = _meta(S)
    if rows is None:
        return _tex_sample_rgba_slow(xp, S, uv, tex_idx)[..., :3]
    q, cx, cy = _nb_fetch(xp, S, uv, tex_idx, rows, nc=3)
    tl, tr = q[..., 0:3], q[..., 3:6]
    bl, br = q[..., 6:9], q[..., 9:12]
    cxe = cx[..., None]
    cye = cy[..., None]
    return (tl * (1 - cye) + bl * cye) * (1 - cxe) + (
        tr * (1 - cye) + br * cye
    ) * cxe


def tex_sample1(xp, S, uv, tex_idx):
    """Red-channel sample (texture_sampler.cl texGetSample1f)."""
    rows = _meta(S)
    if rows is None:
        return _tex_sample_rgba_slow(xp, S, uv, tex_idx)[..., 0]
    q, cx, cy = _nb_fetch(xp, S, uv, tex_idx, rows, nc=1)
    tl, tr, bl, br = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (tl * (1 - cy) + bl * cy) * (1 - cx) + (
        tr * (1 - cy) + br * cy
    ) * cx


def tex_bump_sample3(xp, S, uv, tex_idx):
    """3-tap height-to-normal reconstruction (texture_sampler.cl:187-253).

    Returns 0.5 + 0.5*normalize(s1-s0, s2-s0, 1), like the reference, so the
    caller's ``*2-1`` decode applies uniformly to bump and normal maps.
    The three taps are the tl/tr/bl corners of the same 2x2 neighborhood,
    so the single-lookup fast path serves them too.
    """
    rows = _meta(S)
    if rows is None:
        return _tex_bump_sample3_slow(xp, S, uv, tex_idx)
    q, _, _ = _nb_fetch(xp, S, uv, tex_idx, rows, nc=1)
    s0, s1, s2 = q[..., 0], q[..., 1], q[..., 2]
    dx = s1 - s0
    dy = s2 - s0
    inv_len = 1.0 / xp.sqrt(dx * dx + dy * dy + 1.0)
    n = xp.stack([dx * inv_len, dy * inv_len, inv_len], axis=-1)
    return 0.5 + 0.5 * n


def mat_sample3(xp, S, uv, default3, tex_idx, field=None):
    """Texture-or-constant float3 (material_sampler.cl matGetSample3f).

    ``field`` names the material field so texture-free scenes can skip the
    atlas gathers entirely (ops/statics.py); when the host proved no node of
    this field has a texture, every ``tex_idx`` is -1 and the where() below
    would select ``default3`` on all lanes anyway.
    """
    if field is not None:
        from .statics import tex_on

        if not tex_on(S, field):
            return default3
    sampled = tex_sample3(xp, S, uv, tex_idx)
    return xp.where((tex_idx < 0)[..., None], default3, sampled)


def mat_sample1(xp, S, uv, default1, tex_idx, field=None):
    if field is not None:
        from .statics import tex_on

        if not tex_on(S, field):
            return default1
    sampled = tex_sample1(xp, S, uv, tex_idx)
    return xp.where(tex_idx < 0, default1, sampled)


# ----- fallback path (S built without the _tex_meta static): the original
# 7-lookup bilinear fetch — 4 corner row-gathers + 3 table gathers -----


def _fetch_rgba(xp, S, base_px):
    """Gather 4 consecutive floats starting at pixel slot ``base_px*4``."""
    tex = S["tex_data"].reshape(-1, 4)
    return tex[base_px]


def _bilinear_setup(xp, S, uv, tex_idx):
    """Common uv -> texel corner indices + lerp coefficients."""
    # Byte-stored scenes must never fall through to this flat-f32 path
    # (their offsets index the u8 atlas -> garbage texels). The u8-atlas
    # size is static even under jit tracing, so this check fires for
    # device-array S dicts too; the value check covers hand-built S with
    # tex_store set but no tex_data_u8 (ADVICE r4 #4).
    u8 = S.get("tex_data_u8")
    byte_scene = u8 is not None and getattr(u8, "size", 0) > 0
    store = S.get("tex_store")
    if not byte_scene and store is not None:
        try:
            byte_scene = bool((np.asarray(store) != 0).any())
        except Exception:  # traced store values: the size check above
            byte_scene = False  # already covers every compiled scene
    if byte_scene:
        raise ValueError(
            "byte-stored textures (tex_store != 0) are only served by the "
            "_tex_meta fast path; build S via SceneData.split_params(), or "
            "compile the scene with float_textures=True for the legacy "
            "flat-f32 fallback"
        )
    safe_idx = xp.maximum(tex_idx, 0)
    w = S["tex_width"][safe_idx]
    h = S["tex_height"][safe_idx]
    off = S["tex_offset"][safe_idx] // 4  # pixel offset
    wf = w.astype(uv.dtype)
    hf = h.astype(uv.dtype)
    su = (uv[..., 0] - xp.floor(uv[..., 0])) * wf
    sv = (uv[..., 1] - xp.floor(uv[..., 1])) * hf
    tx = xp.clip(su.astype(w.dtype), 0, w - 1)
    ty = xp.clip(sv.astype(h.dtype), 0, h - 1)
    bx = xp.clip(tx + 1, 0, w - 1)
    by = xp.clip(ty + 1, 0, h - 1)
    cx = su - tx.astype(uv.dtype)
    cy = sv - ty.astype(uv.dtype)
    return off, w, tx, ty, bx, by, cx, cy


def _tex_sample_rgba_slow(xp, S, uv, tex_idx):
    off, w, tx, ty, bx, by, cx, cy = _bilinear_setup(xp, S, uv, tex_idx)
    tl = _fetch_rgba(xp, S, off + ty * w + tx)
    tr = _fetch_rgba(xp, S, off + ty * w + bx)
    bl = _fetch_rgba(xp, S, off + by * w + tx)
    br = _fetch_rgba(xp, S, off + by * w + bx)
    cxe = cx[..., None]
    cye = cy[..., None]
    return (tl * (1 - cye) + bl * cye) * (1 - cxe) + (tr * (1 - cye) + br * cye) * cxe


def _tex_bump_sample3_slow(xp, S, uv, tex_idx):
    off, w, tx, ty, bx, by, cx, cy = _bilinear_setup(xp, S, uv, tex_idx)
    s0 = _fetch_rgba(xp, S, off + ty * w + tx)[..., 0]
    s1 = _fetch_rgba(xp, S, off + ty * w + bx)[..., 0]
    s2 = _fetch_rgba(xp, S, off + by * w + tx)[..., 0]
    dx = s1 - s0
    dy = s2 - s0
    inv_len = 1.0 / xp.sqrt(dx * dx + dy * dy + 1.0)
    n = xp.stack([dx * inv_len, dy * inv_len, inv_len], axis=-1)
    return 0.5 + 0.5 * n
