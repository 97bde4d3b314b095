"""8-wide BVH traversal: the host collapse, the plain PyTorch traversal that
both 8-wide kernels share, and the wrappers of ``csrc/intersect_wide8.cu``.

Counterpart of the JAX package's ``ops/intersect_pallas8.py``
(``collapse_wide``, ``pack_scene8``, ``intersect_pallas8``, TPU kernel
``_kernel``). What is kept is the node layout, the entry encoding, the child
order and the leaf test:

  * the binary two-level BVH is collapsed host-side into nodes of up to 8
    children by SAH-greedy frontier expansion (always open the inner child
    of largest surface area); boxes ``(W,48)`` and entries ``(W,8)`` apart
  * ``entry = type<<28 | count<<22 | index`` (type 0 empty, 1 wide node,
    2 triangle leaf, 3 instance): index and node count below 2^22
  * a visit slab-tests all 8 children, continues at the nearest hit child
    and pushes the other hit children in slot order; an instance entry
    transforms the ray and the stack watermark restores it
  * quotient-form Möller–Trumbore (``leaf="quot"``,
    ``ops/intersect.py::mt_block``): this TPU kernel, alone among the five,
    divides per triangle

Every key of the JAX packer is kept bit for bit (``pk_boxes``, ``pk_entry``,
``pk_inst_entry``, ``pk_root``, ``pk_tris``, ``pk_w2o``); the port adds two
plain ints: ``root_entry`` (``pk_root`` as a launch argument) and
``stack_need``, the deepest the per-ray stack can get. It refuses a tree that
needs more than ``STACK_SIZE`` entries (the TPU kernel clips silently).
``max_leaf``, the static unroll bound of the TPU kernel's leaf loop, has no
counterpart: the loop runs to the entry's own count.

``pack_scene_k4`` builds, beside those arrays, the buffer the kernel reads
(``csrc/intersect_wide8.cu``), one buffer of 16-byte words:

  * a 224-byte record per wide node, in ``pk_boxes``' order: its 48 box
    floats as twelve words (children ``2p`` and ``2p+1`` in words
    ``3p .. 3p+2``, as K2's records), then its 8 entries as two words, in
    K4's own 28/22-bit encoding and slot order
  * 64-byte instance rows ``[3x4 matrix, the instance's entry, 0, 0, 0]``
  * 48-byte triangle rows ``[v0, 0, e1, 0, e2, 0]``

with the stack each thread gets (``stack_need``, at least 1) and the staging
branch (``intersect_cuda.block_staging``: the whole buffer in shared memory
when it is small beside the stacks, cornell's and instanced's, else read
through L1 and L2). The kernel runs the block-local schedule of
``csrc/traverse_block.cuh``.

``traverse_wide`` is the PLAIN VERSION of both 8-wide kernels (this one and
``ops/intersect_wide8_nodes.py``): per-lane stacks advanced in lock step,
parametrised by a ``WideLayout`` that fetches a node's boxes and entries and
decodes an entry, and by the leaf test (``leaf=``); for K4 it reads the
JAX-equal arrays. On CUDA tensors the wrappers launch the kernel on
``P["k4_words"]`` or raise; they take the plain version only for CPU tensors.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import _launch
from . import vec as V
from .intersect_cuda import block_staging, det2_rows, instance_rows
from .intersect import (
    Hit,
    TriArrays,
    _inv_dir,
    _slab_test,
    _xform,
    Touched,
    mt_leaves,
    tested_in_leaf,
    packed_tris,
)

SOURCE = "intersect_wide8.cu"
STACK_SIZE = 96
WIDTH = 8
# 16-byte words of one of K4's own node records: 12 of boxes, 2 of entries
REC_WORDS = 14

T_EMPTY = 0
T_WIDE = 1
T_BOT = 2
T_TOP = 3

LAUNCHES = {"closest_hit": 0, "any_hit": 0}

_POINTERS = (
    ("pk_boxes", torch.float32),
    ("pk_entry", torch.int32),
    ("pk_inst_entry", torch.int32),
    ("pk_tris", torch.float32),
    ("pk_w2o", torch.float32),
)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- host packer


def entry22(typ: int, index: int, count: int = 0) -> int:
    if not (0 <= index < (1 << 22) and 0 <= count < (1 << 6)):
        raise ValueError(f"entry out of range: index {index}, count {count}")
    return (typ << 28) | (count << 22) | index


def unpack22(e):
    """(typ, cnt, idx) of 28/22-bit entries; ints or integer arrays/tensors."""
    return (e >> 28) & 0x7, (e >> 22) & 0x3F, e & 0x3FFFFF


def collapse_wide(scene, entry: Callable, share_blas: bool):
    """Collapse the binary two-level BVH into 8-wide nodes (host-side).

    ``entry(typ, index, count)`` packs a child entry. With ``share_blas``
    instances that share a BLAS share its wide subtree; without, each
    instance gets its own copy (as the two JAX packers do). Returns
    ``(boxes (W,48) f32, entries (W,8) i32, root_entry, inst_entry (I,))``
    with the entries as Python ints / an int64 array of their unsigned
    values.
    """
    ld = scene.bvh_ldata.tolist()
    rd = scene.bvh_rdata.tolist()
    bmin = scene.bvh_min
    bmax = scene.bvh_max
    # float32 throughout, in the association of the JAX packers' area()
    s = bmax - bmin
    area = (s[:, 0] * s[:, 1] + s[:, 1] * s[:, 2] + s[:, 0] * s[:, 2]).tolist()

    frontiers: list = []  # per wide node: the binary nodes in its slots
    wc_entry: list = []

    def leaf_entry(i):
        if rd[i] == 0:  # top-level leaf -> instance
            return entry(T_TOP, -ld[i])
        return entry(T_BOT, -ld[i], rd[i])

    def collapse(root):
        """The packed entry for the subtree at binary node ``root``. Wide
        nodes are numbered in pre-order: a node before its children's
        subtrees, those in slot order (explicit stack, no recursion)."""
        if ld[root] <= 0:
            return leaf_entry(root)
        first = len(wc_entry)
        todo = [(root, None, 0)]  # binary node, parent wide node, slot
        while todo:
            node, parent, slot = todo.pop()
            frontier = [ld[node], rd[node]]
            while len(frontier) < WIDTH:
                cands = [f for f in frontier if ld[f] > 0]
                if not cands:
                    break
                x = max(cands, key=area.__getitem__)
                frontier.remove(x)
                frontier += [ld[x], rd[x]]
            w = len(wc_entry)
            frontiers.append(frontier)
            wc_entry.append([0] * WIDTH)
            if parent is not None:
                wc_entry[parent][slot] = entry(T_WIDE, w)
            inner = []
            for sl, f in enumerate(frontier):
                if ld[f] > 0:
                    inner.append((f, w, sl))
                else:
                    wc_entry[w][sl] = leaf_entry(f)
            todo.extend(reversed(inner))  # slot 0's subtree is numbered first
        return entry(T_WIDE, first)

    root_entry = collapse(0)
    cache: Dict[int, int] = {}
    inst_entry = []
    for r in scene.inst_bvh_root.tolist():
        if not share_blas:
            inst_entry.append(collapse(r))
        else:
            if r not in cache:
                cache[r] = collapse(r)
            inst_entry.append(cache[r])

    n_wide = max(len(wc_entry), 1)
    boxes = np.zeros((n_wide, WIDTH, 6), np.float32)
    entries = np.zeros((n_wide, WIDTH), np.int64)
    if wc_entry:
        entries[:] = np.asarray(wc_entry, np.int64)
        w_idx = np.repeat(np.arange(len(frontiers)), [len(f) for f in frontiers])
        s_idx = np.concatenate([np.arange(len(f)) for f in frontiers])
        nodes = np.concatenate([np.asarray(f, np.int64) for f in frontiers])
        boxes[w_idx, s_idx, 0:3] = bmin[nodes]
        boxes[w_idx, s_idx, 3:6] = bmax[nodes]
    return (
        boxes.reshape(n_wide, WIDTH * 6), entries, int(root_entry),
        np.asarray(inst_entry, np.int64),
    )


def wide_stack_need(entries, root_entry, inst_entry, unpack) -> int:
    """The most entries a ray's stack can hold while it walks this tree: a
    visit pushes every hit child but the one it continues at, so below a
    node with ``c`` children up to ``c - 1`` entries wait. The maximum over
    all root-to-leaf paths, instance subtrees included."""
    typ, _, idx = unpack(entries)
    n_child = (typ != T_EMPTY).sum(axis=1)
    i_typ, _, i_idx = unpack(inst_entry)
    need = 0
    waiting = np.full(entries.shape[0], -1, np.int64)  # most seen per node
    r_typ, _, r_idx = unpack(int(root_entry))
    todo = []

    def enter(t, i, above):
        # an instance entry hands over to the instance's subtree
        if t == T_TOP:
            t, i = int(i_typ[i]), int(i_idx[i])
        if t == T_WIDE and above > waiting[i]:
            waiting[i] = above
            todo.append(i)

    enter(int(r_typ), int(r_idx), 0)
    while todo:
        w = todo.pop()
        below = int(waiting[w]) + max(int(n_child[w]) - 1, 0)
        need = max(need, below)
        for sl in range(WIDTH):
            enter(int(typ[w, sl]), int(idx[w, sl]), below)
    return need


def check_stack(need: int) -> None:
    if need > STACK_SIZE:
        raise ValueError(
            f"the 8-wide tree can hold {need} entries on a ray's stack; the "
            f"traversal stack holds {STACK_SIZE}"
        )


def packed_common(scene) -> Dict[str, np.ndarray]:
    """Triangle rows ``[v0, e1, e2]`` and 3x4 matrix rows, flat f32."""
    tris = (
        np.concatenate([scene.tri_v0, scene.tri_e1, scene.tri_e2], axis=1)
        .astype(np.float32)
        .reshape(-1)
    )
    return {
        "pk_tris": tris,
        "pk_w2o": scene.inst_w2o[:, :3, :].astype(np.float32).reshape(-1),
    }


def pack_scene8(scene) -> Dict:
    boxes, entries, root_entry, inst_entry = collapse_wide(
        scene, entry22, share_blas=False
    )
    if boxes.shape[0] >= (1 << 22):
        raise ValueError("more than 2^22 wide nodes")
    need = wide_stack_need(entries, root_entry, inst_entry, unpack22)
    check_stack(need)
    return {
        "pk_boxes": boxes.reshape(-1),
        "pk_entry": entries.astype(np.int32).reshape(-1),
        "pk_inst_entry": inst_entry.astype(np.int32),
        "pk_root": np.full(1, root_entry, np.int32),
        **packed_common(scene),
        "root_entry": int(root_entry),
        "stack_need": need,
    }


def pack_scene_k4(p8) -> Dict:
    """K4's own buffer from the host arrays of ``pack_scene8`` (see the
    module docstring): ``k4_words`` (int32, 16-byte words), the counts the
    kernel takes, the stack it gives each thread and the staging branch."""
    boxes = np.asarray(p8["pk_boxes"], np.float32).reshape(-1, WIDTH * 6)
    entries = np.asarray(p8["pk_entry"], np.int32).reshape(-1, WIDTH)
    tris = np.asarray(p8["pk_tris"], np.float32).reshape(-1, 9)
    w2o = np.asarray(p8["pk_w2o"], np.float32).reshape(-1, 12)
    records = np.concatenate([boxes.view(np.int32), entries], axis=1)
    need = int(p8["stack_need"])
    check_stack(need)
    cap = max(1, need)
    words = np.concatenate([
        records.ravel(), instance_rows(w2o, p8["pk_inst_entry"]).ravel(),
        det2_rows(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]).view(np.int32).ravel(),
    ])
    where, smem = block_staging(words.size // 4, cap)
    return {
        "k4_words": words, "num_wide": boxes.shape[0], "num_inst": w2o.shape[0],
        "num_tris": tris.shape[0], "stack_cap": cap, "staging": where, "smem_bytes": smem,
    }


# ------------------------------------------------------ plain traversal


class WideLayout(NamedTuple):
    """What the 8-wide traversal reads of a packed scene. ``fetch(node)`` maps
    wide-node indices [n] to ``(boxes [n,8,6], entries [n,8] int64)``;
    ``unpack(e)`` decodes int64 entries (unsigned values) to
    ``(typ, cnt, idx)``."""

    fetch: Callable
    unpack: Callable
    root: int
    inst_entry: torch.Tensor  # [I] int64, unsigned values
    tris: TriArrays
    w2o: torch.Tensor  # [I,3,4]
    num_nodes: int


def traverse_wide(
    L: WideLayout, o, d, maxt, active, *, any_hit: bool, leaf: str,
    stats: Optional[dict] = None,
) -> Hit:
    """8-wide two-level traversal for all lanes, advanced in lock step: each
    trip every live lane handles the entry it holds (enter an instance, test
    a leaf, or visit a wide node) exactly as one thread of the CUDA kernels
    does (``csrc/intersect_wide8.cu``, ``csrc/traverse_wide.cuh``). ``leaf``
    names the leaf test (``ops/intersect.py::LEAF_TESTS``).

    ``stats`` receives the keys of ``traverse_binary``'s: ``inner`` counts
    wide-node visits and ``slabs`` the slab tests of their non-empty slots.
    When ``stats`` holds ``per_lane`` set true it also receives each lane's
    own counts, ``lane_inner`` (wide visits) and ``lane_tris`` (triangle
    tests) ([N] int64, summing to ``inner`` and ``tris`` of this call), and
    ``stack_peak``, the most entries any lane's stack held: what
    ``ops/intersect.py::simt_ceilings`` reads.
    """
    n = o.shape[0]
    dev = o.device
    i32, i64 = torch.int32, torch.int64
    num_inst = L.w2o.shape[0]
    rows = torch.arange(n, device=dev)
    slots = torch.arange(WIDTH, device=dev)

    live = active.clone()
    entry = torch.full((n,), int(L.root), dtype=i64, device=dev)
    stack = torch.zeros((n, STACK_SIZE), dtype=i64, device=dev)
    sp = torch.zeros(n, dtype=i64, device=dev)
    msbi = torch.full((n,), -1, dtype=i64, device=dev)
    cur_o, cur_d = o, d
    inv = _inv_dir(d)
    inv0 = inv
    inst = torch.zeros(n, dtype=i32, device=dev)
    best_t = torch.where(active, maxt, 0.0).to(torch.float32)
    best_tri = torch.zeros(n, dtype=i32, device=dev)
    best_inst = torch.zeros(n, dtype=i32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    n_wide = torch.zeros((), dtype=i64, device=dev)
    n_tris = torch.zeros((), dtype=i64, device=dev)
    n_inst = torch.zeros((), dtype=i64, device=dev)
    n_slabs = torch.zeros((), dtype=i64, device=dev)
    trips = 0
    touched = None
    per_lane = stats is not None and bool(stats.get("per_lane"))
    if stats is not None:
        touched = Touched(dev, L.num_nodes, L.tris.v0.shape[0], num_inst)
    if per_lane:
        lane_inner = torch.zeros(n, dtype=i64, device=dev)
        lane_tris = torch.zeros(n, dtype=i64, device=dev)
        stack_peak = torch.zeros((), dtype=i64, device=dev)

    while bool(live.any()):
        trips += 1
        typ, cnt, idx = L.unpack(entry)
        is_top = live & (typ == T_TOP)
        is_bot = live & (typ == T_BOT)
        is_wide = live & (typ == T_WIDE)
        pop = live & (typ == T_EMPTY)

        # ---------- instance entry: transform the ray, jump to the subtree
        inst_id = torch.clamp(idx, max=num_inst - 1)
        w2o = L.w2o[inst_id]
        to = _xform(w2o, cur_o, 1)
        td = _xform(w2o, cur_d, 0)
        top3 = is_top[:, None]
        cur_o = torch.where(top3, to, cur_o)
        cur_d = torch.where(top3, td, cur_d)
        inv = torch.where(top3, _inv_dir(td), inv)
        inst = torch.where(is_top, inst_id.to(i32), inst)
        msbi = torch.where(is_top, sp, msbi)
        entry = torch.where(is_top, L.inst_entry[inst_id], entry)

        # ---------- triangle leaf, on the lanes that hold one
        at = is_bot.nonzero().squeeze(1)
        if at.numel():
            c = cnt[at]
            hit, bt, bu, bv, btri = mt_leaves(
                L.tris, idx[at], c, cur_o[at], cur_d[at], best_t[at],
                closest=not any_hit, leaf=leaf,
            )
            if any_hit:
                found[at] = found[at] | hit
                live[at[hit]] = False
            else:
                hi = at[hit]
                best_t[hi] = bt[hit]
                best_u[hi] = bu[hit]
                best_v[hi] = bv[hit]
                best_tri[hi] = btri[hit].to(i32)
                best_inst[hi] = inst[hi]
                found[hi] = True
            if touched is not None:
                tested = tested_in_leaf(hit, btri, idx[at], c, any_hit=any_hit)
                touched.runs(idx[at], tested)
                n_tris += tested.sum()
                if per_lane:
                    lane_tris[at] += tested
        pop = pop | (is_bot & live)

        # ---------- wide node: slab all 8 children; nearest first, push rest
        at = is_wide.nonzero().squeeze(1)
        if at.numel():
            boxes, ents = L.fetch(idx[at])
            m = at.numel()
            e_typ = L.unpack(ents)[0]
            wo = cur_o[at][:, None, :].expand(m, WIDTH, 3).reshape(-1, 3)
            wi = inv[at][:, None, :].expand(m, WIDTH, 3).reshape(-1, 3)
            wb = best_t[at][:, None].expand(m, WIDTH).reshape(-1)
            bx = boxes.reshape(-1, 6)
            dist = _slab_test(wo, wi, bx[:, 0:3], bx[:, 3:6], wb).reshape(m, WIDTH)
            dist = torch.where(e_typ != T_EMPTY, dist, V.FLT_MAX)
            near_d = dist.min(dim=1).values
            hit_any = near_d < V.FLT_MAX
            # the first slot of least distance
            near_s = torch.where(
                dist == near_d[:, None], slots[None, :], WIDTH
            ).min(dim=1).values
            near_s = torch.clamp(near_s, max=WIDTH - 1)
            push = (dist < V.FLT_MAX) & (slots[None, :] != near_s[:, None])
            sp_w = sp[at]
            for sl in range(WIDTH):
                p = push[:, sl]
                if bool(p.any()):
                    rp = at[p]
                    stack[rp, torch.clamp(sp_w[p], max=STACK_SIZE - 1)] = ents[p, sl]
                    sp_w = sp_w + p.to(i64)
            sp[at] = sp_w
            if per_lane:
                stack_peak = torch.maximum(stack_peak, sp_w.max())
            go = at[hit_any]
            entry[go] = ents.gather(1, near_s[:, None])[:, 0][hit_any]
            pop[at[~hit_any]] = True
            if touched is not None:
                touched.nodes[idx[at]] = True
                n_wide += m
                if per_lane:
                    lane_inner[at] += 1
                n_slabs += (e_typ != T_EMPTY).sum()

        # ---------- pop (restore the ray when an instance is exhausted)
        restore = (pop & (sp == msbi))[:, None]
        cur_o = torch.where(restore, o, cur_o)
        cur_d = torch.where(restore, d, cur_d)
        inv = torch.where(restore, inv0, inv)
        msbi = torch.where(restore[:, 0], -1, msbi)
        sp = torch.where(pop, sp - 1, sp)
        popped = stack[rows, torch.clamp(sp, 0, STACK_SIZE - 1)]
        entry = torch.where(pop & (sp >= 0), popped, entry)
        live = live & ~(pop & (sp < 0))
        if touched is not None:
            touched.inst[inst_id[is_top]] = True
            n_inst += is_top.sum()

    if stats is not None:
        touched.add_to(stats)
        stats["inner"] = stats.get("inner", 0) + int(n_wide)
        stats["slabs"] = stats.get("slabs", 0) + int(n_slabs)
        stats["tris"] = stats.get("tris", 0) + int(n_tris)
        stats["inst"] = stats.get("inst", 0) + int(n_inst)
        stats["trips"] = stats.get("trips", 0) + trips
    if per_lane:
        stats["lane_inner"], stats["lane_tris"] = lane_inner, lane_tris
        stats["stack_peak"] = int(stack_peak)

    t = torch.where(found, best_t, 0.0)
    return Hit(t, best_inst, best_tri, best_u, best_v, active & found)


def wide8_layout(P) -> WideLayout:
    boxes = P["pk_boxes"].reshape(-1, WIDTH, 6)
    entries = P["pk_entry"].reshape(-1, WIDTH)

    def fetch(node):
        return boxes[node], entries[node].to(torch.int64)

    return WideLayout(
        fetch, unpack22, int(P["root_entry"]), P["pk_inst_entry"].to(torch.int64),
        packed_tris(P["pk_tris"]), P["pk_w2o"].reshape(-1, 3, 4),
        int(boxes.shape[0]),
    )


def wide8_plain(
    P, o, d, maxt, active, *, any_hit: bool, stats: Optional[dict] = None
) -> Hit:
    """The lock-step 8-wide traversal over boxes and entries kept apart."""
    return traverse_wide(
        wide8_layout(P), o, d, maxt, active, any_hit=any_hit, stats=stats,
        leaf="quot",
    )


# ------------------------------------------------------------- the kernel

_LIB = None


def load():
    """Build (first use) and bind the kernel library; cached per process."""
    global _LIB
    if _LIB is None:
        _LIB = _launch.bind(
            SOURCE, "polaris_wide8_closest_hit", "polaris_wide8_any_hit", "p" + "i" * 7,
        )
    return _LIB


def _scene_args(P, device):
    """The kernel's scene arguments: its own buffer, once the packed arrays
    and the buffer built from them are checked to agree."""
    _launch.packed_pointers(P, _POINTERS, device)
    num_wide = P["pk_entry"].numel() // WIDTH
    num_tris = P["pk_tris"].numel() // 9
    num_inst = P["pk_w2o"].numel() // 12
    if P["pk_boxes"].numel() != num_wide * WIDTH * 6 or P["pk_inst_entry"].numel() != num_inst:
        raise ValueError("packed boxes, entries or instance entries disagree in length")
    check_stack(int(P["stack_need"]))
    if "k4_words" not in P:
        raise ValueError("K4 reads its own buffer: pack the scene with pack_scene_k4 "
                         "(make_intersectors does)")
    words = P["k4_words"]
    _launch.check("k4_words", words, torch.int32, 1, device)
    n_words = REC_WORDS * num_wide + 4 * num_inst + 3 * num_tris
    if (P["num_wide"], P["num_inst"], P["num_tris"]) != (num_wide, num_inst, num_tris) \
            or words.numel() != 4 * n_words:
        raise ValueError("k4_words: not the buffer of these packed arrays (wrong length)")
    return [
        words.data_ptr(), n_words, num_wide, num_inst, num_tris, int(P["root_entry"]),
        P["stack_cap"], int(P["staging"] == "shared"),
    ]


def closest_hit(P, o, d, maxt, active) -> Hit:
    """Closest hit per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return wide8_plain(P, o, d, maxt, active, any_hit=False)
    hit = _launch.run_closest(load()[0], _scene_args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "closest_hit")
    return hit


def any_hit(P, o, d, maxt, active) -> torch.Tensor:
    """Occlusion mask per ray through the CUDA kernel (plain version on CPU)."""
    if o.device.type != "cuda":
        return wide8_plain(P, o, d, maxt, active, any_hit=True).mask
    found = _launch.run_any(load()[1], _scene_args(P, o.device), o, d, maxt, active)
    _launch.count(LAUNCHES, "any_hit")
    return found
