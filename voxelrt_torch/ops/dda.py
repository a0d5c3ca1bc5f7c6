"""Hierarchical-DDA voxel traversal over ray batches: the portable traversal
(the PyTorch port of voxelrt/ops/dda.py, plain PyTorch).

Every ray advances in lock-step through one loop whose body performs
exactly ONE occupancy query per iteration: a descend (occupied, lod > 0 ->
lod - 1) or a watertight integer advance to the next cell boundary (empty).

Semantics kept from the reference (renderer/raytracer.py:72-155):
  * the advance cap of 512: a ray that exhausts it returns its current
    (finite) distance, not a miss;
  * the boundary-voxel initial normal;
  * the final normal flip toward the ray.

The JAX package runs this traversal on the CPU and the GPU when
``use_pallas_dda`` is False. The port always traces with kernel B1
(ops/dda_kernel.py) and keeps this module as B1's second oracle: the JAX
package documents both routes as giving the same per-ray results.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPS = 1e-6
INF = float("inf")


class OccupancyPyramid(NamedTuple):
    """Packed occupancy bitfield + static geometry (see voxelrt_torch.world).
    ``words`` holds the u32 words' bits as int32."""

    words: torch.Tensor
    grid_res: int
    n_lods: int

    @property
    def bases(self) -> np.ndarray:
        sizes = [(self.grid_res >> i) ** 3 for i in range(self.n_lods)]
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def query_occupancy(pyr: OccupancyPyramid, ipos, lod):
    """renderer/raytracer.py:40-44: the bit for cell ``ipos`` at ``lod``.

    ipos: (..., 3) int32 cell coords at that lod; lod: (...,) int32."""
    bases = pyr.bases
    res = pyr.grid_res
    flat = torch.zeros(lod.shape, dtype=torch.int32, device=lod.device)
    for k in range(pyr.n_lods):
        r = res >> k
        f_k = int(bases[k]) + (ipos[..., 2] * r + ipos[..., 1]) * r + ipos[..., 0]
        flat = torch.where(lod == k, f_k, flat)
    word = pyr.words[(flat >> 5).clamp(0, pyr.words.shape[0] - 1).long()]
    return ((word >> (flat & 31)) & 1) != 0


class TraceResult(NamedTuple):
    distance: torch.Tensor  # (N,) f32, grid units; inf on miss
    ipos: torch.Tensor  # (N, 3) int32 LOD-0 cell index ((-1,-1,-1) on miss)
    normal: torch.Tensor  # (N, 3) f32 face normal, flipped toward the ray
    iters: torch.Tensor  # (N,) int32 advance count


def _ray_aabb_intersection(box_min, box_max, o, d):
    """renderer/math_utils.py:103-123, IEEE-division form (the JAX
    package's ops/sampling.ray_aabb_intersection on (N, 3) rows)."""
    safe_d = torch.where(d == 0.0, 1e-30, d)
    i1 = (box_min - o) / safe_d
    i2 = (box_max - o) / safe_d
    near = torch.minimum(i1, i2).amax(-1)
    far = torch.maximum(i1, i2).amin(-1)
    outside = ((d == 0.0) & ((o < box_min) | (o > box_max))).any(-1)
    return (near <= far) & ~outside, near, far


def raytrace(pyr: OccupancyPyramid, origin, direction, ray_min_t, ray_max_t,
             max_advances: int = 512) -> TraceResult:
    """Trace rays against the occupancy pyramid in grid space [0, res)^3.

    origin/direction: (N, 3) f32 tensors; min/max t: a float or (N,) f32."""
    n = origin.shape[0]
    dev = origin.device
    f32 = torch.float32
    res = pyr.grid_res
    n_lods = pyr.n_lods
    res_f = float(res)
    ray_min_t = torch.as_tensor(ray_min_t, dtype=f32, device=dev).expand(n)
    ray_max_t = torch.as_tensor(ray_max_t, dtype=f32, device=dev).expand(n)

    box_max = torch.full((3,), res_f, dtype=f32, device=dev)
    hit_box, bbox_near, bbox_far = _ray_aabb_intersection(
        torch.zeros(3, dtype=f32, device=dev), box_max, origin, direction)
    alive0 = hit_box & (ray_min_t < bbox_far) & (ray_max_t > bbox_near)
    t0 = torch.maximum(bbox_near, ray_min_t)
    initial_p = origin + direction * (t0 + EPS)[:, None]
    ipos0 = torch.clamp(torch.floor(initial_p), 0.0, res_f - 1.0).to(torch.int32)
    # a zero component gives a huge-but-finite step time instead of
    # 0 * inf = NaN on exact cell boundaries
    inv_dir = 1.0 / torch.clamp(direction.abs(), min=1e-20)
    far = torch.minimum(ray_max_t, bbox_far) - EPS

    # boundary-voxel initial normal (raytracer.py:98-101)
    initial_dist = (initial_p - res_f * 0.5).abs()
    max_dist = initial_dist.amax(-1, keepdim=True)
    normal = (initial_dist == max_dist).to(f32)

    sign_d = torch.sign(direction)
    t = torch.where(alive0, t0, INF)
    ipos = torch.where(alive0[:, None], ipos0, -1)
    lod = torch.zeros(n, dtype=torch.int32, device=dev)
    normal = torch.where(alive0[:, None], normal, 0.0)
    active = alive0
    advances = torch.zeros(n, dtype=torch.int32, device=dev)

    # each advance is followed by at most one lod increment, so the
    # descends of a whole ray never exceed advances + n_lods
    for _ in range(2 * max_advances + n_lods + 2):
        if not bool(active.any()):
            break
        # a miss past the far clip (raytracer.py:104-106) or outside the
        # grid (the far-clip comparison can miss the exit face by an ulp)
        inb = ((ipos >= 0) & (ipos < res)).all(-1)
        miss = active & ((t > far) | ~inb)

        cell = ipos >> lod[:, None]
        occ = query_occupancy(pyr, cell.clamp(min=0), lod)
        live = active & ~miss
        hit_now = live & occ & (lod == 0)
        descend = live & occ & (lod > 0)
        advance = live & ~occ

        # advance to the nearest boundary of the current-lod cell
        # (raytracer.py:124-147), watertight via integer reconstruction
        cell_size = (torch.ones_like(lod) << lod).to(f32)[:, None]
        cell_base = cell.to(f32) * cell_size
        voxel_pos = origin + direction * t[:, None]
        frac = voxel_pos - cell_base
        dist = torch.where(direction > 0.0, cell_size - frac, frac)
        # an axis the ray does not move along is never the crossing axis
        t_axes = torch.where(direction == 0.0, INF, dist * inv_dir)
        min_t = t_axes.amin(-1)
        edge = torch.minimum(torch.clamp(
            torch.floor(frac + min_t[:, None] * direction), min=0.0),
            cell_size - 1.0)
        adv_normal = (t_axes == min_t[:, None]).to(f32) * sign_d
        adv_ipos = (cell_base + edge + adv_normal).to(torch.int32)
        adv_lod = torch.clamp(lod + 1, max=n_lods - 1)

        t = torch.where(miss, INF, torch.where(advance, t + min_t, t))
        ipos = torch.where(advance[:, None], adv_ipos, ipos)
        lod = torch.where(descend, lod - 1, torch.where(advance, adv_lod, lod))
        normal = torch.where(advance[:, None], adv_normal, normal)
        advances = advances + advance.to(torch.int32)
        exhausted = advance & (advances >= max_advances)
        active = active & ~miss & ~hit_now & ~exhausted

    flip = (direction * normal).sum(-1) > 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    return TraceResult(t, ipos, normal, advances)


def disagreements(ref: TraceResult, distance, ipos, normal) -> torch.Tensor:
    """Per ray, whether a trace (``distance`` (N,), ``ipos`` and ``normal``
    (N, 3)) disagrees with ``ref`` by the rule of the JAX package's
    tests/test_dda_pallas.py:52-66: the hit flags differ, or both hit with
    distances more than 1e-2 apart, or both hit the same cell with other
    normals. A hit in a neighbouring cell at the same distance (a grazed
    edge) agrees."""
    hit_r = torch.isfinite(ref.distance)
    both = hit_r & torch.isfinite(distance)
    same_cell = (ref.ipos == ipos).all(-1)
    far = (ref.distance - distance).abs() > 1e-2
    other_normal = (ref.normal != normal).any(-1)
    return (hit_r != torch.isfinite(distance)) | (
        both & (far | (same_cell & other_normal)))
