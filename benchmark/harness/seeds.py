"""Everything a run draws comes from `--seed`: the same seed gives the same
frames, pixels, targets and probe rays."""

from __future__ import annotations

import numpy as np

# purposes, so that no two draws of one run share a stream
FRAME, PIXELS, PICK, TARGET, PROBE, WARM = range(6)


def _sequence(seed: int, *keys: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2**64 - 1), *keys])


def derive(seed: int, *keys: int) -> int:
    """A 32-bit seed for the renderer, from the run's seed and ``keys``."""
    return int(_sequence(seed, *keys).generate_state(1, np.uint32)[0])


def generator(seed: int, *keys: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(_sequence(seed, *keys)))
