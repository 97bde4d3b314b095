"""The port's counter-based RNG against the JAX package's, bit for bit.

``polaris_tpu_torch.ops.rng.uniform`` (int64 lanes masked to 32 bits) must
return exactly the float32 values of ``rng.np_uniform`` and
``rng.jnp_uniform`` for every stream: the renderers only replay the same
paths if every draw is the same number. Tolerance: none (``==``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from polaris_tpu.ops import rng as jrng  # noqa: E402
from polaris_tpu_torch.ops import rng as trng  # noqa: E402

STREAMS = [n for n in dir(jrng) if n.startswith("STREAM_")]
SEEDS = [0, 1, 2**32 - 1]


def _pixels():
    r = np.random.default_rng(0)
    return np.concatenate(
        [
            np.arange(4096, dtype=np.int64),
            r.integers(0, 2**20, 8192),
            np.array([2**20 - 1, 2**20], dtype=np.int64),
        ]
    )


def test_stream_ids_match():
    assert STREAMS, "no STREAM_* ids found"
    for name in STREAMS:
        assert getattr(trng, name) == getattr(jrng, name), name


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream", STREAMS)
def test_uniform_bit_equal_scalar_counters(seed, stream):
    import jax.numpy as jnp

    pix = _pixels()
    sid = getattr(jrng, stream)
    for sample, bounce in ((0, 0), (7, 1), (15, 4), (1000, 63)):
        counter = bounce * 64 + sid
        want = jrng.np_uniform(seed, pix.astype(np.uint32), sample, counter)
        got = trng.uniform(seed, torch.from_numpy(pix), sample, counter)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        via_jnp = np.asarray(
            jrng.jnp_uniform(
                jnp.uint32(seed), jnp.asarray(pix.astype(np.uint32)), sample, counter
            )
        )
        np.testing.assert_array_equal(got.numpy(), via_jnp)
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_make_uniform_per_lane_bounce_and_sample(seed):
    """Path regeneration keys draws by per-lane bounce and sample tensors."""
    import jax.numpy as jnp

    pix = _pixels()
    r = np.random.default_rng(1)
    sample = r.integers(0, 64, pix.shape[0])
    bounce = r.integers(0, 8, pix.shape[0])
    U_t = trng.make_uniform(
        seed, torch.from_numpy(pix), torch.from_numpy(sample), torch.from_numpy(bounce)
    )
    U_np = jrng.make_uniform(
        jrng.np_uniform, seed, pix.astype(np.uint32), sample.astype(np.int32),
        bounce.astype(np.uint32),
    )
    U_j = jrng.make_uniform(
        jrng.jnp_uniform, jnp.uint32(seed), jnp.asarray(pix.astype(np.uint32)),
        jnp.asarray(sample.astype(np.int32)), jnp.asarray(bounce.astype(np.uint32)),
    )
    for name in STREAMS:
        sid = getattr(jrng, name)
        got = U_t(sid).numpy()
        np.testing.assert_array_equal(got, U_np(sid), err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(U_j(sid)), err_msg=name)


def test_make_uniform_python_int_bounce_equals_tensor_bounce():
    pix = torch.arange(2048)
    as_int = trng.make_uniform(3, pix, 5, 2)
    as_tensor = trng.make_uniform(
        3, pix, torch.full((2048,), 5), torch.full((2048,), 2)
    )
    for name in STREAMS:
        sid = getattr(trng, name)
        assert torch.equal(as_int(sid), as_tensor(sid)), name


@pytest.mark.parametrize("width", [32, 100, 512, 1000])
def test_rr_block_key_equal(width):
    pix = np.arange(width * 64, dtype=np.int64)
    want = jrng.rr_block_key(np, pix.astype(np.uint32), width)
    got = trng.rr_block_key(torch.from_numpy(pix), width)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_rr_key_replaces_pixel_key_for_the_rr_stream_only():
    pix = torch.arange(4096)
    key = trng.rr_block_key(pix, 64)
    U = trng.make_uniform(0, pix, 1, 2, rr_key=key)
    plain = trng.make_uniform(0, pix, 1, 2)
    by_block = trng.make_uniform(0, key, 1, 2)
    assert torch.equal(U(trng.STREAM_RR), by_block(trng.STREAM_RR))
    assert torch.equal(U(trng.STREAM_BXDF_U), plain(trng.STREAM_BXDF_U))
    want = jrng.np_uniform(0, key.numpy().astype(np.uint32), 1, 2 * 64 + jrng.STREAM_RR)
    np.testing.assert_array_equal(U(trng.STREAM_RR).numpy(), want)
