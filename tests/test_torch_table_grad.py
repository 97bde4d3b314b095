"""The gradient of a small parameter table's gather (``csrc/table_grad.cu``,
``ops/table_grad_cuda.py``).

On the CPU:

  * the plain version (the kernel's lane partition and summation order in
    PyTorch) against ``index_add_``, each element within ``SUM_TOL`` of the
    sum of the magnitudes added into it, for tables of 1 to 64 rows, 1 or 3
    columns and 1 to 300,000 lanes, with lanes on random rows, every lane on
    one row, and rows that no lane reads (exact zeros)
  * two calls bit-equal
  * the autograd wrapper: its forward is ``index_select`` bit for bit, its
    backward the plain version on the CPU
  * the rule that sends a gather to the kernel (``route``), as a function
    of device, gradient, shape and dtype, and ``take_small`` taking each of
    its three paths; the fallback counted where its backward runs
  * ``LAUNCHES`` is one of ``_launch.launch_tables()``; the layout constants
    are the source's; the benchmark's ``scatter_ms.step`` reads the kernels
    by their symbols

On a card (marker ``card``; ``python -m pytest --noconftest -m card
tests/test_torch_table_grad.py``, on the machine with the card, whose
Python has no JAX for the repo's ``tests/conftest.py``): the kernel against
the plain version bit for bit, two launches bit-equal, and the gather's
forward and backward replayed from a captured CUDA graph.
"""

import importlib.util
import os
import re

import pytest
import torch

from polaris_tpu_torch.ops import _launch
from polaris_tpu_torch.ops import table_grad_cuda as TG
from polaris_tpu_torch.ops import vec as V

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# of the sum of the |values| added into an element: index_add_ adds the lanes
# in turn, the plain version in blocks; at 300,000 lanes on one row the two
# differ by 4e-8 of it
SUM_TOL = 1e-6
LANES = [1, 33, 1024, 4097, 300_000]  # one block exactly, and ragged ends


def gather_node(rows):
    """The name of the autograd node of the gather under ``take_small``'s
    reshape."""
    node = rows.grad_fn
    while type(node).__name__.startswith(("View", "Reshape", "Unsafe")):
        node = node.next_functions[0][0]
    return type(node).__name__


def inputs(n, rows, width, pattern, seed=0):
    gen = torch.Generator().manual_seed(seed + 7919 * n + 31 * rows + width)
    g = torch.randn((n, width), generator=gen)
    if pattern == "random":
        idx = torch.randint(0, rows, (n,), generator=gen)
    elif pattern == "one_row":
        idx = torch.full((n,), rows - 1, dtype=torch.long)
    else:  # "holes": the even rows only, so the odd ones get exact zeros
        idx = 2 * torch.randint(0, (rows + 1) // 2, (n,), generator=gen)
    return g, idx


@pytest.mark.parametrize("pattern", ["random", "one_row", "holes"])
@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("rows", [1, 2, 3, 17, 64])
def test_plain_matches_index_add(rows, width, n, pattern):
    g, idx = inputs(n, rows, width, pattern)
    got = TG.table_grad_plain(g, idx, rows)
    want = torch.zeros(rows, width).index_add_(0, idx, g)
    scale = torch.zeros(rows, width).index_add_(0, idx, g.abs())
    assert got.shape == (rows, width) and got.dtype == torch.float32
    assert torch.all((got - want).abs() <= SUM_TOL * scale)
    unread = scale == 0
    assert torch.equal(got[unread], torch.zeros(int(unread.sum())))
    if pattern == "holes" and rows > 1:
        assert bool(unread[1].all())


@pytest.mark.parametrize("n, rows, width", [(0, 3, 3), (5, 2, 1), (2049, 3, 3), (300_000, 64, 3)])
def test_plain_is_bit_reproducible(n, rows, width):
    g, idx = inputs(n, rows, width, "random", seed=1)
    a = TG.table_grad_plain(g, idx, rows)
    b = TG.table_grad_plain(g.clone(), idx.clone(), rows)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if n == 0:
        assert torch.equal(a, torch.zeros(rows, width))


def test_plain_negative_zeros_add_as_index_add_does():
    g = torch.full((40, 3), -0.0)
    got = TG.table_grad_plain(g, torch.zeros(40, dtype=torch.long), 2)
    want = torch.zeros(2, 3).index_add_(0, torch.zeros(40, dtype=torch.long), g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", [(3,), (2, 3), (3, 3), (5, 3, 3), (1,)])
def test_gather_forward_is_index_select_and_backward_the_plain_sum(shape):
    gen = torch.Generator().manual_seed(len(shape) * 10 + shape[0])
    table = torch.randn(shape, generator=gen, requires_grad=True)
    idx = torch.randint(0, shape[0], (2500,), generator=gen)
    rows = TG.gather(table, idx)
    assert torch.equal(rows, torch.index_select(table.detach(), 0, idx))
    out = torch.randn(rows.shape, generator=gen)
    (got,) = torch.autograd.grad(rows, table, out)
    width = rows[0].numel()
    want = TG.table_grad_plain(out.reshape(-1, width), idx, shape[0]).view(shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "device, records, shape, dtype, way",
    [
        ("cuda", True, (3, 3), torch.float32, TG.KERNEL),
        ("cuda", True, (3,), torch.float32, TG.KERNEL),
        ("cuda", True, (2, 3, 3), torch.float32, TG.KERNEL),
        ("cuda", True, (1024,), torch.float32, TG.KERNEL),
        ("cuda", True, (342, 3), torch.float32, TG.INDEX_ADD),  # 1,026 floats
        ("cuda", True, (1025,), torch.float32, TG.INDEX_ADD),
        ("cuda", True, (3, 3), torch.float64, TG.INDEX_ADD),
        ("cuda", True, (0, 3), torch.float32, TG.INDEX_ADD),
        ("cuda", False, (3, 3), torch.float32, TG.PLAIN),
        ("cuda", False, (4096,), torch.float32, TG.PLAIN),
        ("cpu", True, (3, 3), torch.float32, TG.PLAIN),
        ("cpu", True, (4096,), torch.float32, TG.PLAIN),
        ("cpu", False, (3, 3), torch.float32, TG.PLAIN),
    ],
)
def test_route(device, records, shape, dtype, way):
    assert TG.route(device, records, shape, dtype) == way


def test_route_of_reads_grad_mode_and_requires_grad(monkeypatch):
    table = torch.ones(3, 3, requires_grad=True)
    seen = []
    real = TG.route
    monkeypatch.setattr(TG, "route", lambda *a: seen.append(a) or real(*a))
    assert TG.route_of(table) == TG.PLAIN
    with torch.no_grad():
        TG.route_of(table)
    TG.route_of(table.detach())
    assert seen == [("cpu", True, (3, 3), torch.float32), ("cpu", False, (3, 3), torch.float32),
                    ("cpu", False, (3, 3), torch.float32)]


@pytest.mark.parametrize("way", [TG.KERNEL, TG.INDEX_ADD, TG.PLAIN])
def test_take_small_takes_the_routed_path(monkeypatch, way):
    monkeypatch.setattr(TG, "route_of", lambda table: way)
    TG.reset_launches()
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(3, 3, generator=gen, requires_grad=True)
    idx = torch.randint(0, 3, (64, 4), generator=gen, dtype=torch.int32)
    rows = V.take_small(table, idx)
    assert rows.shape == (64, 4, 3)
    assert torch.equal(rows, table.detach()[idx.long()])
    assert ("_Gather" in gather_node(rows)) == (way == TG.KERNEL)
    out = torch.randn(rows.shape, generator=gen)
    (got,) = torch.autograd.grad(rows, table, out)
    flat = idx.reshape(-1).long()
    if way == TG.KERNEL:  # on the CPU the kernel's path sums by the plain version
        assert torch.equal(got, TG.table_grad_plain(out.reshape(-1, 3), flat, 3))
    else:
        assert torch.equal(got, torch.zeros(3, 3).index_add_(0, flat, out.reshape(-1, 3)))
    assert TG.LAUNCHES == {"table_grad": 0, "table_grad_fallback": int(way == TG.INDEX_ADD)}
    TG.reset_launches()


def test_take_small_on_the_cpu_is_index_select():
    table = torch.randn(7, 3, requires_grad=True)
    idx = torch.randint(0, 7, (100,))
    rows = V.take_small(table, idx)
    assert gather_node(rows) == "IndexSelectBackward0"
    with torch.no_grad():
        assert V.take_small(table, idx).grad_fn is None


def test_launches_are_a_launch_table_and_the_layout_the_sources():
    assert any(t is TG.LAUNCHES for t in _launch.launch_tables())
    assert set(TG.LAUNCHES) == {"table_grad", "table_grad_fallback"}
    with open(os.path.join(REPO, "polaris_tpu_torch", "csrc", TG.SOURCE)) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["WARPS"]) == TG.WARPS and int(consts["ROUNDS"]) == TG.ROUNDS
    assert int(consts["MAX_TABLE"]) == TG.MAX_TABLE
    assert TG.LANES_PER_BLOCK == TG.WARPS * TG.ROUNDS * 32


def test_the_benchmark_reads_the_scatter_by_its_symbols():
    path = os.path.join(REPO, "benchmark", "metrics", "scatter_ms.step.py")
    spec = importlib.util.spec_from_file_location("scatter_ms_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(REPO, "polaris_tpu_torch", "csrc", TG.SOURCE)) as f:
        kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(", f.read())
    assert kernels == ["table_grad_partials", "table_grad_reduce"]
    for name in kernels:
        assert mod.is_scatter(f"polaris_table::{name}(float const*, int, int, float*)")
    assert mod.is_scatter("void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, "
                          "true, at::native::ReduceAdd>(...)")
    for other in ("void at::native::indexSelectLargeIndex<float, long, unsigned int, 2, 2, -2>(...)",
                  "polaris_shade::shade_bounce_kernel(polaris_shade::ShadeArgs)",
                  "void at::native::vectorized_gather_kernel<16, long>(...)"):
        assert not mod.is_scatter(other)

    class Trace:
        units = 2
        kernels = {"polaris_table::table_grad_partials(...)": (400, 0.003),
                   "polaris_table::table_grad_reduce(...)": (400, 0.001),
                   "polaris_shade::shade_bounce_kernel(...)": (10, 1.0)}

        def seconds_where(self, pred):
            return sum(s for n, (_, s) in self.kernels.items() if pred(n))

    reading = type("R", (), {"trace": Trace()})()
    assert mod.read(reading) == pytest.approx(2.0)
    Trace.kernels = {"polaris_shade::shade_bounce_kernel(...)": (10, 1.0)}
    assert mod.read(reading) is None


# ----------------------------------------------------------------- on a card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU build)")
    return torch.device("cuda")


def bits(x):
    return x.contiguous().view(torch.int32).cpu()


@pytest.mark.card
@pytest.mark.parametrize("pattern", ["random", "one_row", "holes"])
@pytest.mark.parametrize("n, rows, width", [
    (1, 1, 1), (33, 2, 3), (1024, 3, 3), (4097, 17, 1), (262_144, 3, 3), (262_144, 2, 3),
    (262_144, 3, 1), (300_000, 64, 3), (300_000, 1024, 1), (100_003, 1, 1024),
])
def test_kernel_equals_plain_bit_for_bit(card, n, rows, width, pattern):
    g, idx = inputs(n, rows, width, pattern)
    g, idx = g.to(card), idx.to(card)
    TG.reset_launches()
    got = TG.table_grad(g, idx, rows)
    again = TG.table_grad(g, idx, rows)
    torch.cuda.synchronize()
    assert TG.LAUNCHES["table_grad"] == 2
    assert torch.equal(bits(got), bits(TG.table_grad_plain(g.cpu(), idx.cpu(), rows)))
    assert torch.equal(bits(got), bits(again))


@pytest.mark.card
def test_kernel_gather_replays_from_a_captured_graph(card):
    gen = torch.Generator().manual_seed(5)
    table = torch.randn(3, 3, generator=gen).to(card).requires_grad_(True)
    idx = torch.randint(0, 3, (262_144,), generator=gen).to(card)
    out = torch.randn(262_144, 3, generator=gen).to(card)
    grad = torch.empty(3, 3, device=card)

    def step():
        rows = V.take_small(table, idx)
        (g,) = torch.autograd.grad(rows, table, out)
        grad.copy_(g)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # the warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    TG.reset_launches()
    with torch.cuda.graph(graph, stream=stream):
        step()
    assert TG.LAUNCHES == {"table_grad": 1, "table_grad_fallback": 0}
    want = TG.table_grad_plain(out.cpu(), idx.cpu(), 3)
    for _ in range(2):
        grad.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(bits(grad), bits(want))


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(card):
    g = torch.zeros(64, 3, device=card)
    idx = torch.zeros(64, dtype=torch.long, device=card)
    for bad_g, bad_idx, rows in (
        (g.double(), idx, 3),  # dtype
        (g, idx.int(), 3),
        (g[:, 0], idx, 3),  # dims
        (g.t().contiguous().t(), idx, 3),  # layout
        (g, idx[:63], 3),  # lanes
        (g, idx, 342),  # 1,026 floats
        (g, idx, 0),
    ):
        with pytest.raises((TypeError, ValueError)):
            TG.table_grad(bad_g, bad_idx, rows)
