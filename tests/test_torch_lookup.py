"""PyTorch port: ``voxelrt_torch.ops.lookup`` against the JAX package's
``voxelrt.ops.lookup`` on random tables, out-of-range indices included:
bit for bit (a one-hot matmul of a finite table reads each row exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.ops import lookup as jl

from voxelrt_torch.materials import MaterialList, fetch_material
from voxelrt_torch.ops import lookup as tl

torch.set_num_threads(1)


def _data(seed, shape, n_idx, lo, hi):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(lo, hi, n_idx).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("shape", [(37,), (37, 5)])
def test_gather_1d_clips(shape):
    table, idx = _data(0, shape, (4, 9), -5, 45)
    want = np.asarray(jl.gather_1d(jnp.asarray(table), jnp.asarray(idx)))
    got = tl.gather_1d(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_take_rows(axis):
    table, idx = _data(1, (11, 13, 3), (7,), -3, 16)
    want = np.asarray(jl.take_rows(jnp.asarray(table), jnp.asarray(idx),
                                   axis=axis))
    got = tl.take_rows(torch.from_numpy(table), torch.from_numpy(idx), axis)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_lookup_onehot():
    table, idx = _data(2, (128, 14), (300,), -4, 140)
    want = np.asarray(jl.lookup_onehot(jnp.asarray(table), jnp.asarray(idx)))
    got = tl.lookup_onehot(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), want)
    # fetch_material reads the palette through it: outside ids read zeros
    mats = MaterialList().params("cpu")
    ids = torch.tensor([-1, 0, 50, 127, 128], dtype=torch.int32)
    m = fetch_material(mats, ids)
    assert torch.equal(m.roughness, tl.lookup_onehot(mats, ids)[:, 7])
    assert m.roughness[0] == 0 and m.roughness[-1] == 0


def test_lookup_2d_onehot():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(16, 8, 3)).astype(np.float32)
    i = rng.integers(-2, 18, (50,)).astype(np.int32)
    j = rng.integers(-2, 10, (50,)).astype(np.int32)
    want = np.asarray(jl.lookup_2d_onehot(jnp.asarray(table), jnp.asarray(i),
                                          jnp.asarray(j)))
    got = tl.lookup_2d_onehot(torch.from_numpy(table), torch.from_numpy(i),
                              torch.from_numpy(j))
    assert np.array_equal(got.numpy(), want)
