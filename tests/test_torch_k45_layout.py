"""K4's and K5's own buffers, their staging rule, and the block-local
schedule they run, on the CPU.

The kernels ``csrc/intersect_wide8.cu`` (K4) and ``csrc/intersect_dense.cu``
(K5) run the block-local live-ray schedule of ``csrc/traverse_block.cuh``
over buffers of their own, which ``pack_scene_k4`` / ``pack_scene_k5`` build
beside the arrays that equal the JAX packers' (``pack_scene8`` /
``pack_scene_dense``, held by ``tests/test_torch_traversal_modes.py``). Their
plain versions read those JAX-equal arrays. Here, on cornell, instanced and
sphere (no Pallas, no JAX call):

  * K4's records decode to ``pk_boxes`` and ``pk_entry``, its instance and
    triangle rows to ``pk_inst_entry``, ``pk_w2o`` and ``pk_tris``, bit for
    bit; K5's rows to ``pk_w2o``, ``pk_ranges`` and ``pk_tris``
  * the staging rule, by byte count
  * a plain walk over K4's buffer equals ``wide8_plain`` bit for bit, and
    ``stack_cap`` bounds its stack
  * K5's loop over its buffer, one triangle at a time accepted in order
    against the numerators over one denominator, equals ``dense_plain`` bit
    for bit
  * the schedule's window and compaction map, transcribed from
    ``live_windows`` and ``launch_block``, hands every active ray to exactly
    one thread and writes every inactive one exactly once
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu_torch.asset.compiler.compiler import compile_scene  # noqa: E402
from polaris_tpu_torch.asset.wavefront import read_scene  # noqa: E402
from polaris_tpu_torch.ops import intersect as tix  # noqa: E402
from polaris_tpu_torch.ops import intersect_cuda as k1  # noqa: E402
from polaris_tpu_torch.ops import intersect_dense as k5  # noqa: E402
from polaris_tpu_torch.ops import intersect_wide8 as k4  # noqa: E402
from polaris_tpu_torch.ops._launch import upload_packed  # noqa: E402

SCENES = ["cornell", "instanced", "sphere"]
FLT_MAX = float(np.finfo(np.float32).max)
H100_SMS = 132


@pytest.fixture(scope="module")
def compiled(scenes_dir):
    return {
        name: compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))
        for name in SCENES
    }


@pytest.fixture(scope="module")
def packed(compiled):
    """scene -> (K4's arrays + own buffer, K5's arrays + own buffer), host."""
    out = {}
    for name, scene in compiled.items():
        p8 = k4.pack_scene8(scene)
        pd = k5.pack_scene_dense(scene)
        out[name] = ({**p8, **k4.pack_scene_k4(p8)}, {**pd, **k5.pack_scene_k5(pd)})
    return out


def _rays(scene, seed, n=640):
    """Seeded rays from points inside the scene's box: random directions,
    every fourth with a short ``maxt`` (shadow-like), every eighth inactive."""
    g = np.random.default_rng(seed)
    lo, hi = scene.bvh_min[0], scene.bvh_max[0]
    o = (lo + g.uniform(0.05, 0.95, (n, 3)) * (hi - lo)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, FLT_MAX, np.float32)
    maxt[::4] = g.uniform(0.05, 1.0, n)[::4] * float(np.linalg.norm(hi - lo))
    active = np.ones(n, bool)
    active[::8] = False
    return tuple(torch.from_numpy(x) for x in (o, d, maxt, active))


def _equal(a, b):
    for f in tix.Hit._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", SCENES)
def test_k4_buffer_decodes_to_the_packer_arrays(packed, name):
    P, _ = packed[name]
    words = P["k4_words"]
    W, I, T = P["num_wide"], P["num_inst"], P["num_tris"]
    assert words.dtype == np.int32
    assert words.size == 4 * (k4.REC_WORDS * W + 4 * I + 3 * T)
    rec = words[: 4 * k4.REC_WORDS * W].reshape(W, 4 * k4.REC_WORDS)
    np.testing.assert_array_equal(rec[:, :48].view(np.float32).ravel(), P["pk_boxes"])
    np.testing.assert_array_equal(rec[:, 48:].ravel(), P["pk_entry"])
    inst = words[4 * k4.REC_WORDS * W : 4 * (k4.REC_WORDS * W + 4 * I)].reshape(I, 16)
    np.testing.assert_array_equal(inst[:, :12].view(np.float32).ravel(), P["pk_w2o"])
    np.testing.assert_array_equal(inst[:, 12], P["pk_inst_entry"])
    assert not inst[:, 13:].any()
    tris = words[4 * (k4.REC_WORDS * W + 4 * I) :].reshape(T, 12)
    rows = tris.view(np.float32)
    np.testing.assert_array_equal(
        np.concatenate([rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]], axis=1).ravel(),
        P["pk_tris"],
    )
    assert not tris[:, 3::4].any()
    assert P["stack_cap"] == max(1, P["stack_need"])


@pytest.mark.parametrize("name", SCENES)
def test_k5_buffer_decodes_to_the_packer_arrays(packed, name):
    _, P = packed[name]
    words = P["k5_words"]
    I, T = P["num_inst"], P["num_tris"]
    assert words.dtype == np.int32 and words.size == 4 * (4 * I + 3 * T)
    inst = words[: 16 * I].reshape(I, 16)
    np.testing.assert_array_equal(inst[:, :12].view(np.float32).ravel(), P["pk_w2o"])
    np.testing.assert_array_equal(inst[:, 12:14].ravel(), P["pk_ranges"])
    assert not inst[:, 14:].any()
    rows = words[16 * I :].reshape(T, 12).view(np.float32)
    np.testing.assert_array_equal(
        np.concatenate([rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]], axis=1).ravel(),
        P["pk_tris"],
    )


def test_staging_rule_by_counts(packed):
    """The buffer and the stacks of a block of ``BLOCK_THREADS`` staged in
    shared memory when they take at most ``BLOCK_STAGE_BYTES``: cornell and
    instanced for both kernels, not sphere (62-78 KB)."""
    threads = k1.BLOCK_THREADS
    for name in SCENES:
        p4, p5 = packed[name]
        assert p4["smem_bytes"] == 4 * p4["k4_words"].size + 4 * p4["stack_cap"] * threads
        assert p5["smem_bytes"] == 4 * p5["k5_words"].size
        want = "global" if name == "sphere" else "shared"
        assert p4["staging"] == p5["staging"] == want, name
    assert 4 * packed["cornell"][0]["k4_words"].size == 3_776
    spare = k1.BLOCK_STAGE_BYTES - 4 * 10 * threads
    assert k1.block_staging(spare // 16, 10) == ("shared", k1.BLOCK_STAGE_BYTES)
    assert k1.block_staging(spare // 16 + 1, 10)[0] == "global"
    # the kernels' constant, as the staging rule counts it
    src = os.path.join(os.path.dirname(k1.__file__), "..", "csrc", "traverse_block.cuh")
    with open(src) as f:
        assert f"constexpr int BLOCK_RAYS = {threads};\n" in f.read()


def _k4_layout(P) -> k4.WideLayout:
    """K4's own buffer as the 8-wide traversal reads it: what the kernel's
    reader loads, word for word."""
    words = P["k4_words"]
    W, I = P["num_wide"], P["num_inst"]
    inst_at = 4 * k4.REC_WORDS * W
    tri_at = inst_at + 16 * I
    rec = words[:inst_at].view(W, 4 * k4.REC_WORDS)
    inst = words[inst_at:tri_at].view(I, 16)
    rows = words[tri_at:].view(torch.float32).view(-1, 12)

    def fetch(node):
        r = rec[node]
        return r[:, :48].view(torch.float32).reshape(-1, k4.WIDTH, 6), r[:, 48:].to(torch.int64)

    return k4.WideLayout(
        fetch, k4.unpack22, int(P["root_entry"]), inst[:, 12].to(torch.int64),
        tix.TriArrays(rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]),
        inst.view(torch.float32)[:, :12].reshape(-1, 3, 4), W,
    )


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_plain_walk_over_k4_buffer_equals_wide8_plain(compiled, packed, name, any_hit):
    P = upload_packed(packed[name][0], "cpu")
    rays = _rays(compiled[name], seed=11)
    ref_stats, stats = {}, {"per_lane": True}
    ref = k4.wide8_plain(P, *rays, any_hit=any_hit, stats=ref_stats)
    got = k4.traverse_wide(_k4_layout(P), *rays, any_hit=any_hit, leaf="quot", stats=stats)
    if any_hit:
        assert torch.equal(got.mask, ref.mask)
    else:
        _equal(got, ref)
    assert ref.mask.any() and (~ref.mask & rays[3]).any()
    assert stats["stack_peak"] <= P["stack_cap"]
    for k in ("inner", "slabs", "tris", "inst"):
        assert stats[k] == ref_stats[k], k


def _k5_kernel_loop(P, o, d, maxt, active, *, any_hit: bool) -> tix.Hit:
    """K5's loop (``csrc/intersect_dense.cu``, ``scan_rows``) over its own
    buffer, all rays in lock step: per instance the ray moved once, then
    each triangle of its range in order, tested and accepted against the
    numerators over one denominator; one divide per ray."""
    words = P["k5_words"]
    I, T = P["num_inst"], P["num_tris"]
    inst = words[: 16 * I].view(I, 16)
    w2o = inst.view(torch.float32)[:, :12].reshape(I, 3, 4)
    ranges = inst[:, 12:14].tolist()
    rows = words[16 * I :].view(torch.float32).view(T, 12)
    tris = tix.TriArrays(rows[:, 0:3], rows[:, 4:7], rows[:, 8:11])
    n = o.shape[0]
    best_t = torch.where(active, maxt, 0.0)
    den = torch.ones(n)
    best_u, best_v = torch.zeros(n), torch.zeros(n)
    best_tri = torch.zeros(n, dtype=torch.int32)
    best_inst = torch.zeros(n, dtype=torch.int32)
    found = torch.zeros(n, dtype=torch.bool)
    for ii, (first, count) in enumerate(ranges):
        m = w2o[ii : ii + 1].expand(n, 3, 4)
        io, idr = tix._xform(m, o, 1), tix._xform(m, d, 0)
        for tri in range(first, first + count):
            ok, u, v, t, det_a = (
                x[:, 0] for x in tix._mt_tests_det2(tris, torch.full((n, 1), tri), io, idr)
            )
            if any_hit:
                found |= active & ~found & ok & (t < best_t * det_a)
                continue
            acc = active & ok & (t * den < best_t * det_a)
            found |= acc
            best_t = torch.where(acc, t, best_t)
            den = torch.where(acc, det_a, den)
            best_u = torch.where(acc, u, best_u)
            best_v = torch.where(acc, v, best_v)
            best_tri = torch.where(acc, tri, best_tri)
            best_inst = torch.where(acc, ii, best_inst)
    inv = 1.0 / den
    t = torch.where(found, best_t * inv, 0.0)
    return tix.Hit(t, best_inst, best_tri, best_u * inv, best_v * inv, active & found)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_k5_in_order_acceptance_equals_dense_plain(compiled, packed, name, any_hit):
    """On cornell (18 instances of two triangles), instanced and sphere."""
    P = upload_packed(packed[name][1], "cpu")
    rays = _rays(compiled[name], seed=24)
    ref = k5.dense_plain(P, *rays, any_hit=any_hit)
    got = _k5_kernel_loop(P, *rays, any_hit=any_hit)
    assert ref.mask.any() and (~ref.mask & rays[3]).any()
    if any_hit:
        assert torch.equal(got.mask, ref.mask)
    else:
        _equal(got, ref)


def _schedule(active: np.ndarray, blocks: int, threads: int):
    """``live_windows`` as each block runs it: per window of ``threads`` rays
    the inactive ones written at once, each warp's active rays written in
    order into its own slot of ``order`` and counted, then thread j takes
    compacted ray j by a prefix over the warps' counts. Returns (rays traced,
    rays written inactive)."""
    n = active.size
    traced, written = [], []
    lane = np.arange(threads)
    for b in range(blocks):
        for base in range(b * threads, n, blocks * threads):
            i = base + lane
            live = (i < n) & active[np.minimum(i, n - 1)]
            written += i[(i < n) & ~live].tolist()
            order = np.full(threads, -1)
            counts = np.zeros(threads // 32, np.int64)
            for w in range(threads // 32):
                votes = live[32 * w : 32 * w + 32]
                rank = np.cumsum(votes) - 1
                order[32 * w + rank[votes]] = i[32 * w : 32 * w + 32][votes]
                counts[w] = votes.sum()
            before = np.concatenate([[0], np.cumsum(counts)])
            for j in range(int(before[-1])):
                w = int(np.searchsorted(before, j, side="right")) - 1
                traced.append(int(order[32 * w + j - before[w]]))
    return traced, written


@pytest.mark.parametrize("n", [0, 1, 31, 33, 65_536])
def test_window_map_covers_every_ray_once(n):
    g = np.random.default_rng(n)
    threads = k1.BLOCK_THREADS
    windows = -(-n // threads)
    patterns = [np.ones(n, bool), g.random(n) < 0.3]
    if n > 1:
        one = np.zeros(n, bool)
        one[n // 2] = True
        patterns.append(one)
    # launch_block's grid: at most SMs x resident blocks, at most one a window
    for active in patterns:
        for blocks in sorted({1, min(H100_SMS * 4, windows), min(7, windows)} - {0}):
            traced, written = _schedule(active, blocks, threads)
            assert sorted(traced) == np.flatnonzero(active).tolist()
            assert sorted(written) == np.flatnonzero(~active).tolist()
    if n == 0:
        assert windows == 0  # launch_block returns before launching
