"""Gather / table-lookup primitives (the PyTorch port of
voxelrt/ops/lookup.py).

On the TPU the JAX package picks a formulation per table size: an XLA
gather, a row gather, or a one-hot matmul on the MXU for small tables. On
the GPU each is a plain indexed load; these functions compute the indexing
the JAX ones compute, out-of-range indices included:

* ``gather_1d``        clamps the index (``jnp.take(..., mode="clip")``);
* ``take_rows``        the same along any axis (the module docstring there
                       calls it ``lookup_rows``);
* ``lookup_onehot``    reads an all-zero row for an index outside the table,
                       as a one-hot matmul does;
* ``lookup_2d_onehot`` the same for a (R, C, K) table at [i, j].

The port calls ``lookup_onehot`` (``materials.fetch_material``); the other
three are kept for parity with the JAX package's API and are held to it by
tests only.
"""

from __future__ import annotations

import torch


def gather_1d(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[(T,) + rest][idx] for integer idx of any shape, clamped."""
    return take_rows(table, idx, 0)


def take_rows(table: torch.Tensor, idx: torch.Tensor, axis: int = 0):
    """``jnp.take(table, idx, axis, mode="clip")``."""
    i = idx.long().clamp(0, table.shape[axis] - 1)
    return torch.index_select(table, axis, i.reshape(-1)).reshape(
        table.shape[:axis] + tuple(idx.shape) + table.shape[axis + 1:])


def lookup_onehot(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) table, (...,) int idx -> (..., C); zeros where idx is outside
    [0, R)."""
    r = table.shape[0]
    valid = (idx >= 0) & (idx < r)
    rows = table[idx.long().clamp(0, r - 1)]
    return torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=table.dtype, device=table.device))


def lookup_2d_onehot(table: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    """(R, C, K) table at [i, j] -> (..., K); zeros where i or j is outside
    the table."""
    r, c, _ = table.shape
    valid = (i >= 0) & (i < r) & (j >= 0) & (j < c)
    vals = table[i.long().clamp(0, r - 1), j.long().clamp(0, c - 1)]
    return torch.where(valid[..., None], vals,
                       torch.zeros((), dtype=table.dtype, device=table.device))
