"""`shade_bounce_ms.frame` on a synthetic trace: the shading kernel alone,
never more than `shade_ms.frame`, and nothing where the trace lacks it."""

import pytest

from harness import cells, trace

SHADE = "polaris_shade::shade_bounce_kernel(polaris_shade::ShadeArgs)"


def reading(kernels, units=2):
    summary = trace.Summary(span_s=1.0, busy_s=0.5, units=units, kernels=kernels, copies={})
    return type("R", (), {"trace": summary})()


def test_reads_the_shading_kernel_alone():
    r = reading({
        SHADE: (10, 0.008),
        "polaris_shade::nee_add_kernel(long long, float*, unsigned char const*, unsigned char const*, float const*)": (10, 0.001),
        "void polaris::persistent_kernel<false, 1, true>(...)": (10, 0.020),
        "void at::native::vectorized_elementwise_kernel<4, ...>": (300, 0.004),
    })
    bounce = cells.module("metrics", "shade_bounce_ms.frame").read(r)
    shade = cells.module("metrics", "shade_ms.frame").read(r)
    assert bounce == pytest.approx(4.0)
    assert shade == pytest.approx(6.5) and bounce <= shade


def test_a_trace_without_the_kernel_gives_nothing():
    r = reading({"void at::native::vectorized_elementwise_kernel<4, ...>": (300, 0.004)})
    assert cells.module("metrics", "shade_bounce_ms.frame").read(r) is None

