"""The device trace's arithmetic on synthetic intervals."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from harness import trace


def test_union_of_overlapping_intervals():
    busy, merged = trace.union_length([(0, 10), (5, 12), (20, 25), (21, 22), (12, 13)])
    assert busy == 18
    assert merged == [(0, 13), (20, 25)]
    assert trace.idle_gaps(merged, (-2, 30)) == [(-2, 0), (13, 20), (25, 30)]


def ev(name, start, end, dev, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end), device_type=dev,
        is_user_annotation=annotation,
    )


def test_summary_of_a_synthetic_trace():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev(trace.SPAN, 100.0, 300.0, cpu),
        ev(trace.SPAN, 100.0, 300.0, cuda, annotation=True),  # the span's image on the device
        ev("cudaGraphLaunch", 150.0, 200.0, cpu),
        ev("void persistent_kernel<BinaryReader>(...)", 100.0, 140.0, cuda),
        ev("shade_kernel", 130.0, 150.0, cuda),  # overlaps the one before
        ev("Memcpy DtoH (Device -> Pinned)", 250.0, 260.0, cuda),
        ev("shade_kernel", 262.0, 280.0, cuda),
        ev("outside", 400.0, 500.0, cuda),
    ]
    s = trace.summarize(events, units=2)
    assert s.span_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx((50 + 10 + 18) * 1e-6)
    assert s.idle_share == pytest.approx(1 - 78 / 200)
    assert s.kernel_count() == 3
    assert s.kernels["shade_kernel"] == (2, pytest.approx(38e-6))
    labels = dict(s.gaps)
    # 150..250 is idle while the host is in cudaGraphLaunch until 200
    assert labels["cudaGraphLaunch"] == pytest.approx(100e-6)
    assert sum(labels.values()) == pytest.approx(122e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["void persistent_kernel<BinaryReader>(...)", pytest.approx(40e-6)]
    assert len(b["idle_gaps"]) <= 10


def test_traversal_symbols():
    from harness import cells

    m = cells.module("metrics", "traversal_ms.frame")
    for name in (
        "void persistent_kernel<BinaryReader, false>(Scene, Rays)", "void traverse(Wide8Scene, Rays)",
        "void dense(DenseScene, Rays)", "_Z5dense10DenseScene4Rays",
    ):
        assert m.is_traversal(name), name
    for name in ("void at::native::vectorized_elementwise_kernel<4, ...>", "index_add_dense_kernel_x"):
        assert not m.is_traversal(name), name
