"""The glue of a closest-hit ``next_hit`` on the card: kernel H
(csrc/hit.cu), two launches around B1's dispatch.

``hit_prepare`` forms B1's inputs from the rays (the grid-space origin,
``tmax`` and, with in-kernel NEE, the floor crossing ``alt_t``);
``hit_merge`` forms the ``Hit`` from the rays and B1's outputs (the floor
plane against the voxel, the colour word decoded with its edge darkening).
The floor plane's crossing is computed again in the second launch rather
than kept through the dispatch.

The kernel replaces no TPU kernel: the JAX package leaves this glue to
XLA, which fuses it. Run eagerly on the card it was about 43 elementwise
kernels a sample. Its plain twins are render/pathtracer.py's
``hit_prepare_eager`` and ``hit_merge_eager``, which take the same
arguments and give the same bits, and which any-hit calls and the CPU run
(``hit_kernel_applies``).
"""

from __future__ import annotations

import ctypes

import torch

from voxelrt_torch.ops import _cuda
from voxelrt_torch.ops.v3 import V3
from voxelrt_torch.utils import profiling

# the pointer slots of csrc/hit.cu's table, in its order
SLOTS = ("px", "py", "pz", "dx", "dy", "dz", "mask", "floor_height",
         "ox", "oy", "oz", "tmax", "alt_t",
         "distance", "ix", "iy", "iz", "bnx", "bny", "bnz", "color_word",
         "floor_color", "floor_material", "voxel_edges",
         "closest", "nx", "ny", "nz", "ax", "ay", "az", "hit_light",
         "mat_id")


def hit_kernel_applies(cfg, device) -> bool:
    """Whether a closest-hit ``next_hit`` runs its glue as kernel H: on
    CUDA, on every route of the config (the still and moving paths, path
    A', ReSTIR's closest-hit dispatches and the sorted route, whose B1
    outputs come back in ray order). Any-hit calls keep the eager glue."""
    return torch.device(device).type == "cuda"


def _fn(name):
    """An entry of csrc/hit.cu, its slot count checked on first use."""
    lib = _cuda.lib("hit")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        lib.hit_slots.restype = ctypes.c_int
        if lib.hit_slots() != len(SLOTS):
            raise RuntimeError("csrc/hit.cu's slots differ from SLOTS")
        floats = 2 if name == "hit_prepare" else 3
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_float] * floats
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name, cfg, params, pos, d, mask, slots):
    """Launch ``name`` over the lanes of ``pos``, ``d`` and ``mask`` with
    the other slots from ``slots`` (name: tensor; absent is null)."""
    dev = pos.x.device
    n = pos.x.shape[0]
    lanes = dict(zip(("px", "py", "pz", "dx", "dy", "dz"),
                     (c.contiguous() for c in (*pos, *d))),
                 mask=mask.contiguous())
    f32 = torch.float32
    for slot, t in lanes.items():
        _cuda.require(t, slot, torch.bool if slot == "mask" else f32, dev,
                      (n,))
    _cuda.require(params.floor_height, "floor_height", f32, dev, ())
    table = dict(lanes, floor_height=params.floor_height, **slots)
    ptrs = [None if table.get(s) is None else table[s].data_ptr()
            for s in SLOTS]
    scal = [1.0 / cfg.voxel_dx, cfg.grid_offset]
    if name == "hit_merge":
        scal.append(cfg.voxel_dx)
    err = _fn(name)((ctypes.c_void_p * len(SLOTS))(*ptrs), *scal, n,
                    _cuda.stream_ptr(dev))
    _cuda.check(err, name)
    if n:
        _cuda.LAUNCHES[name] += 1


def hit_prepare(cfg, params, pos, d, mask, nee):
    """Kernel H's first launch: B1's inputs for the rays (``pos``, ``d``:
    V3 of (n,) float32; ``mask``: (n,) bool, the rays that trace), as
    ``hit_prepare_eager`` gives them: (the grid-space origin as a V3, tmax,
    and with ``nee`` the floor crossing alt_t in grid units, else None)."""
    dev = pos.x.device
    n = pos.x.shape[0]
    origin = torch.empty((3, n), dtype=torch.float32, device=dev)
    tmax = torch.empty((n,), dtype=torch.float32, device=dev)
    alt_t = torch.empty_like(tmax) if nee else None
    _launch("hit_prepare", cfg, params, pos, d, mask,
            dict(ox=origin[0], oy=origin[1], oz=origin[2], tmax=tmax,
                 alt_t=alt_t))
    profiling.count("hit.lanes", n, nee=bool(nee), stage="prepare")
    return V3(*origin), tmax, alt_t


def hit_merge(cfg, params, pos, d, mask, tr):
    """Kernel H's second launch: the hit of each ray from the rays and B1's
    closest-hit outputs ``tr`` (distance, ipos, normal, color_word), as
    ``hit_merge_eager`` gives it: (closest, normal, albedo, hit_light,
    mat_id), the fields of ``pathtracer.Hit`` before ``iters``."""
    dev = pos.x.device
    n = pos.x.shape[0]
    f32, i32 = torch.float32, torch.int32
    b1 = dict(distance=tr.distance, ix=tr.ipos.x, iy=tr.ipos.y,
              iz=tr.ipos.z, bnx=tr.normal.x, bny=tr.normal.y,
              bnz=tr.normal.z, color_word=tr.color_word)
    for slot, t in b1.items():
        dtype = i32 if slot in ("ix", "iy", "iz", "color_word") else f32
        _cuda.require(t, slot, dtype, dev, (n,))
    _cuda.require(params.floor_color, "floor_color", f32, dev, (3,))
    _cuda.require(params.floor_material, "floor_material", i32, dev, ())
    _cuda.require(params.voxel_edges, "voxel_edges", f32, dev, ())
    closest = torch.empty((n,), dtype=f32, device=dev)
    normal = torch.empty((3, n), dtype=f32, device=dev)
    albedo = torch.empty((3, n), dtype=f32, device=dev)
    hit_light = torch.empty((n,), dtype=torch.bool, device=dev)
    mat_id = torch.empty((n,), dtype=i32, device=dev)
    _launch("hit_merge", cfg, params, pos, d, mask, dict(
        b1, floor_color=params.floor_color,
        floor_material=params.floor_material,
        voxel_edges=params.voxel_edges, closest=closest, nx=normal[0],
        ny=normal[1], nz=normal[2], ax=albedo[0], ay=albedo[1],
        az=albedo[2], hit_light=hit_light, mat_id=mat_id))
    profiling.count("hit.lanes", n, nee=tr.nee_visible is not None,
                    stage="merge")
    return closest, V3(*normal), V3(*albedo), hit_light, mat_id
