"""Port parity, K4 (block gather): ``fraytracer_tpu_torch.ops.cuda.gather``
on CPU tensors (the plain version behind the wrapper) against numpy
indexing and the JAX kernel in interpret mode — exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraytracer_tpu.ops.pallas.gather import block_gather as jgather
from fraytracer_tpu.ops.pallas.gather import flat_block_gather as jflat
from fraytracer_tpu_torch.ops.cuda.gather import (BLOCK, LAUNCHES,
                                                  block_gather,
                                                  block_gather_plain,
                                                  flat_block_gather)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_block_gather_permutation(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 8, 128)) * 100).astype(dtype)
    idx = rng.permutation(16).astype(np.int32)
    out = block_gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, x[idx])
    np.testing.assert_array_equal(
        out, np.asarray(jgather(jnp.asarray(x), jnp.asarray(idx),
                                interpret=True)))


def test_block_gather_repeat_and_shrink():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 8, 128)).astype(np.float32)
    idx = np.array([3, 3, 0, 7], np.int32)
    out = block_gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, x[idx])
    np.testing.assert_array_equal(
        out, np.asarray(jgather(jnp.asarray(x), jnp.asarray(idx),
                                interpret=True)))


def test_block_gather_grow():
    """More output blocks than input blocks (broadcast by repetition)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 8, 128)).astype(np.float32)
    idx = np.array([2, 0, 1, 1, 2, 0, 0], np.int32)
    out = block_gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, x[idx])


@pytest.mark.parametrize("k", [1, 3])
def test_flat_block_gather_payloads(k):
    rng = np.random.default_rng(2)
    n = 4 * BLOCK
    x = rng.normal(size=(n, k) if k > 1 else (n,)).astype(np.float32)
    idx = np.array([2, 0, 1], np.int32)
    out = flat_block_gather(torch.from_numpy(x), torch.from_numpy(idx),
                            3).numpy()
    want = x.reshape((4, BLOCK) + x.shape[1:])[idx].reshape(
        (3 * BLOCK,) + x.shape[1:])
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        out, np.asarray(jflat(jnp.asarray(x), jnp.asarray(idx), 3,
                              interpret=True)))


def test_flat_block_gather_int():
    rng = np.random.default_rng(3)
    n = 4 * BLOCK
    x = rng.integers(0, 1000, size=(n,)).astype(np.int32)
    idx = np.array([1, 3, 0, 2], np.int32)
    out = flat_block_gather(torch.from_numpy(x), torch.from_numpy(idx),
                            4).numpy()
    np.testing.assert_array_equal(out, x.reshape(4, BLOCK)[idx].reshape(-1))


def test_out_of_range_index_gives_zero_block():
    x = torch.arange(2 * 8 * 128, dtype=torch.float32).reshape(2, 8, 128)
    out = block_gather_plain(x, torch.tensor([1, -1, 2], dtype=torch.int32))
    assert torch.equal(out[0], x[1])
    assert not out[1:].any()


def test_rejects_bad_shapes_and_counts_nothing_on_cpu():
    before = dict(LAUNCHES)
    with pytest.raises(ValueError):
        block_gather(torch.zeros(4, 8, 64), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        flat_block_gather(torch.zeros(BLOCK + 1),
                          torch.zeros(1, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        flat_block_gather(torch.zeros(2 * BLOCK),
                          torch.zeros(2, dtype=torch.int32), 3)
    block_gather(torch.zeros(2, 8, 128), torch.zeros(2, dtype=torch.int32))
    assert LAUNCHES == before   # the plain route is not a kernel launch
