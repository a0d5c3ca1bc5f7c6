"""Checkpoint/resume for progressive renders (the PyTorch port of
voxelrt/utils/checkpoint.py).

The whole ``RenderState`` (ReSTIR's reservoirs included), the RNG key and
the frame counter go through one ``np.savez_compressed`` file, in the JAX
package's own format both ways: the same npz keys (``state.color``, ...,
``state.reservoirs.0.M``, ``state.spp``, ``state.frame``, ``rng.key``,
``meta.frame``, ``extra.<k>``, and ``<k>.__none__`` for a field that is
None) and the JAX package's dtypes on disk. The u32 words the port holds as
int64 (``gbuff_mat_id``, the reservoirs' ``rc_mat_info``) are written as
uint32, the key ``(k0, k1)`` as uint32[2], ``spp`` and ``frame`` as int32
scalars. The JAX package loads without casting, so a file in any other
dtype would not load into its ``init_state`` template. A render started in
either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from voxelrt_torch.interop import render_state_from_jax
from voxelrt_torch.render.pipeline import RenderState

# fields the port holds as int64 tensors of u32 words
_U32 = ("gbuff_mat_id", "rc_mat_info")


def _disk(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if name in _U32 else a


def _flatten(state: RenderState) -> dict:
    out = {}
    for f in dataclasses.fields(RenderState):
        v = getattr(state, f.name)
        k = f"state.{f.name}"
        if v is None:
            out[f"{k}.__none__"] = np.zeros(0)
        elif f.name == "reservoirs":
            for i, slot in enumerate(v):
                for name, t in slot.items():
                    out[f"{k}.{i}.{name}"] = _disk(name, t)
        elif f.name in ("spp", "frame"):
            out[k] = np.asarray(int(v), np.int32)
        else:
            out[k] = _disk(f.name, v)
    return out


def save_render_state(path, state, key, frame: int, extra=None):
    """Write ``state``, the key ``(k0, k1)`` and ``frame`` (and ``extra``, a
    dict of numbers such as the spp counter) to ``path``. A partitioned
    state (parallel.sharding) is written gathered, as one RenderState."""
    if isinstance(state, tuple):
        from voxelrt_torch.parallel.sharding import gather_state

        state = gather_state(state)
    arrays = _flatten(state)
    arrays["rng.key"] = np.asarray([int(key[0]), int(key[1])], np.uint32)
    arrays["meta.frame"] = np.asarray(int(frame))
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load_render_state(path, template: RenderState):
    """Restore ``(state, key, frame, extra)`` from ``path``. ``template``
    (the port's ``init_state(cfg, device)``) gives the structure, the
    shapes, the dtypes and the device; a missing key or a shape that
    differs from the template's raises ``ValueError``."""
    with np.load(path) as z:
        files = set(z.files)

        def arr(k, like, name=None):
            if k not in files:
                raise ValueError(f"{path}: no array {k!r}")
            a = z[k]
            if a.shape != tuple(like.shape):
                raise ValueError(f"{path}: {k} has shape {a.shape}, the "
                                 f"render needs {tuple(like.shape)}")
            if isinstance(like, torch.Tensor) and name not in _U32:
                a = a.astype(torch.empty(0, dtype=like.dtype).numpy().dtype,
                             copy=False)
            return a

        fields = {}
        for f in dataclasses.fields(RenderState):
            v = getattr(template, f.name)
            k = f"state.{f.name}"
            if f.name == "reservoirs":
                fields[f.name] = None if v is None else tuple(
                    {name: arr(f"{k}.{i}.{name}", t, name)
                     for name, t in slot.items()}
                    for i, slot in enumerate(v))
            elif f.name in ("spp", "frame"):
                fields[f.name] = arr(k, np.zeros(()))
            else:
                fields[f.name] = arr(k, v, f.name)
        key = arr("rng.key", np.zeros(2))
        frame = int(z["meta.frame"])
        extra = {k[len("extra."):]: z[k] for k in z.files
                 if k.startswith("extra.")}
    # the u32 words become int64 there, every other array is in the
    # template's dtype already
    state = render_state_from_jax(fields, template.color.device)
    return state, (int(key[0]), int(key[1])), frame, extra
