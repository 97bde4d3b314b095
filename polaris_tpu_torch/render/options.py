"""Render options (ref: renderer/options.go:3-23 + main.go:76-120 defaults)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RenderOptions:
    width: int = 1024
    height: int = 1024
    spp: int = 16
    num_bounces: int = 5
    min_bounces_for_rr: int = 3
    exposure: float = 1.2
    seed: int = 0
    # TPU-native RR variant: draw the Russian-roulette uniform per
    # (32x32 block, sample, bounce) instead of per lane. Each lane's
    # marginal survival probability and 1/p boost are unchanged (unbiased),
    # but blocks die atomically so the traversal kernel's all-dead tile
    # skip triggers at late bounces. Costs intra-block noise correlation;
    # deliberate deviation from the reference's per-lane RR
    # (pt_integrator.cl:112-124) — see docs/perf.md for the measured
    # speed/variance tradeoff.
    rr_tile_coherent: bool = False

    def __post_init__(self):
        # RR disabled by pushing the threshold past the last bounce
        # (ref: cmd/render.go:42-45)
        if self.min_bounces_for_rr <= 0 or self.min_bounces_for_rr > self.num_bounces:
            self.min_bounces_for_rr = self.num_bounces + 1
