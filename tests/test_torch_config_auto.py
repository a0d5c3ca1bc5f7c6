"""PyTorch port: the scene-statistic 'auto' knobs that
``HeadlessRenderer.prepare_data`` resolves, the twin of
tests/test_config_auto.py.

``dda_march_unroll='auto'`` and ``dda_nee_src_open='auto'`` both gate on the
share of LOD2 cells whose whole sun cone provably escapes: an open world
resolves to unroll 3 and ``src_open`` on, an enclosed one to unroll 2 and
``src_open`` off. The port's kernel reads ``dda_nee_src_open`` and ignores
the unroll, but resolves both so that configs stay one to one with the JAX
package's. Each case resolves on the CPU through the port's own renderer,
and the open and the enclosed world also through the JAX package's, which
must resolve the same values."""

import numpy as np
import torch

from voxelrt.app.headless import HeadlessRenderer as JRenderer
from voxelrt.app.testing import tiny_config as jtiny_config
from voxelrt.camera import Camera as JCamera
from voxelrt.world import VoxelWorld as JWorld

from voxelrt_torch.app.headless import HeadlessRenderer
from voxelrt_torch.app.testing import make_test_world, tiny_config
from voxelrt_torch.camera import Camera
from voxelrt_torch.render.pathtracer import march_unroll_of
from voxelrt_torch.world import VoxelWorld

from test_torch_checkpoint import _FakeScene

torch.set_num_threads(1)

OPEN = dict(grid_res=128, voxel_dx=1.0 / 64.0)


def _open_world(world_cls, cfg):
    # The sun-open certificate needs production grid scale to certify cells
    # (at the 32³ test grid even a near-empty world reads about 0): a sparse
    # 128³ world reads wide open, like example6.
    world = world_cls(cfg.voxel_dx, cfg.grid_res, cfg.voxel_edges)
    ii = np.arange(-8, 8)
    xx, zz = np.meshgrid(ii, ii, indexing="ij")
    idx = np.stack([xx.ravel(), np.full(xx.size, -60), zz.ravel()], -1)
    world.set_voxels(idx, 1, np.array([0.6, 0.6, 0.6]))
    return world


def _closed_world(world_cls, cfg):
    # A closed box: no cell's sun cone escapes.
    world = world_cls(cfg.voxel_dx, cfg.grid_res, cfg.voxel_edges)
    r = cfg.grid_res // 2 - 1
    ii = np.arange(-r, r)
    xx, yy = np.meshgrid(ii, ii, indexing="ij")
    flat = np.stack([xx.ravel(), yy.ravel()], -1)
    col = np.array([0.7, 0.7, 0.7])
    for axis in (2, 1, 0):
        for v in (-r, r - 1):
            world.set_voxels(np.insert(flat, axis, v, axis=1), 1, col)
    return world


def _resolved_cfg(world, **over):
    cfg = tiny_config(**over)
    r = HeadlessRenderer(cfg, _FakeScene(cfg, world, Camera()), quiet=True,
                         device="cpu")
    r.prepare_data()
    return r.cfg


def _jax_resolved_cfg(world, **over):
    cfg = jtiny_config(use_pallas_dda=True, pallas_interpret=True, **over)
    r = JRenderer(cfg, _FakeScene(cfg, world, JCamera()), quiet=True)
    r.prepare_data()
    return r.cfg


def _both_resolved(build, **over):
    """The knobs the port and the JAX package resolve on the same world."""
    port = _resolved_cfg(build(VoxelWorld, tiny_config(**over)), **over)
    ref = _jax_resolved_cfg(build(JWorld, jtiny_config(**over)), **over)
    assert port.material_ids == ref.material_ids
    assert port.material_features == ref.material_features
    return [(c.dda_march_unroll, c.dda_nee_src_open) for c in (port, ref)]


def test_auto_unroll_open_scene():
    assert _both_resolved(_open_world, **OPEN) == [(3, "on")] * 2


def test_auto_unroll_enclosed_scene():
    assert _both_resolved(_closed_world) == [(2, "off")] * 2


def test_explicit_unroll_respected():
    cfg = tiny_config()
    cfg2 = _resolved_cfg(make_test_world(cfg), dda_march_unroll=2)
    assert cfg2.dda_march_unroll == 2


def test_unroll_fallback_without_shell():
    # A config built without the app shell (tools, oracle tests) never runs
    # prepare_data; the fallback must yield an int.
    assert march_unroll_of(tiny_config()) == 3
    assert march_unroll_of(tiny_config(dda_march_unroll=1)) == 1
