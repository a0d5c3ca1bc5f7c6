"""Small scene and params builders for tests and demos (the PyTorch port of
voxelrt/app/testing.py).

The configs, the world and the light constants are the JAX package's, so
the same seed gives the same scene in both packages. ``make_scene_data``
and ``make_params`` build the port's ``SceneData`` and ``RenderParams`` on
an explicit device. The port always traces with its kernel B1, so its scene
data always carries the traversal tables, where the JAX package builds them
only under ``use_pallas_dda``; ``production_test_config``'s
``use_pallas_dda=True, pallas_interpret=True`` are fields the port ignores.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelrt_torch.app.headless import _i32
from voxelrt_torch.camera import look_at_matrix, perspective_matrix
from voxelrt_torch.config import RenderConfig
from voxelrt_torch.materials import MaterialList
from voxelrt_torch.ops.accel import add_sun_open_table, build_pallas_tables
from voxelrt_torch.ops.dda_kernel import upload_tables
from voxelrt_torch.render.pathtracer import RenderParams, SceneData
from voxelrt_torch.world import VoxelWorld


def tiny_config(**overrides) -> RenderConfig:
    base = dict(image_res=(64, 32), grid_res=32, voxel_dx=1.0 / 16.0,
                dda_block_rows=8, dda_queue_depth=2)
    base.update(overrides)
    return RenderConfig(**base)


def production_test_config(**overrides) -> RenderConfig:
    """The production feature set on test shapes: queued wavefront +
    in-kernel NEE, and the physical sky + clouds at test-sized knobs."""
    base = dict(
        image_res=(64, 32), grid_res=32, voxel_dx=1.0 / 16.0,
        dda_block_rows=8, dda_queue_depth=2,
        use_pallas_dda=True, pallas_interpret=True,
        use_physical_sky=True, use_clouds=True,
        skybox_res=64, sky_steps=4, sky_sun_samples=2, sky_ms_samples=2,
        sky_ms_steps=2, cloud_steps=4, cloud_sun_samples=2,
        cloud_shadow_steps=2, cloud_accum_passes=2,
    )
    base.update(overrides)
    return RenderConfig(**base)


def make_test_world(cfg: RenderConfig, seed=0) -> VoxelWorld:
    """A platform + pillars + emissive blocks scene (example1-flavoured)."""
    rng = np.random.default_rng(seed)
    world = VoxelWorld(cfg.voxel_dx, cfg.grid_res, cfg.voxel_edges)
    r = cfg.grid_res // 4
    ii, jj = np.meshgrid(np.arange(-r, r), np.arange(-r, r), indexing="ij")
    idx = np.stack([ii.ravel(), np.zeros(ii.size, int), jj.ravel()], -1)
    world.set_voxels(idx, 1, np.array([0.8, 0.6, 0.4]))
    pil = rng.random(len(idx)) < 0.05
    for x, _, z in idx[pil]:
        h = int(rng.random() * (r // 2)) + 1
        ks = np.arange(1, h + 1)
        world.set_voxels(
            np.stack([np.full_like(ks, x), ks, np.full_like(ks, z)], -1),
            np.where(ks == h, 2, 1),
            np.array([0.2, 0.6, 0.9]),
        )
    return world


# Light constants shared by make_scene_data (sun-open table, sky sun) and
# make_params: they must agree for in-kernel NEE and sky tests to mean
# anything.
TEST_LIGHT_DIR = (1.0, 1.0, 1.0)
TEST_LIGHT_COLOR = (1.0, 0.95, 0.9)
TEST_CONE_COS = float(np.cos(0.05))


def make_scene_data(cfg: RenderConfig, device, world: VoxelWorld | None = None,
                    seed=0) -> SceneData:
    """The test scene's SceneData on ``device``. The sky goes through
    ``prepare_sky``'s cache (``.skycache/``), whose files both packages read
    and write under the same key."""
    world = world or make_test_world(cfg, seed)
    arrays = world.device_arrays()
    ld = np.asarray(TEST_LIGHT_DIR, np.float64)
    ld = ld / np.linalg.norm(ld)
    sky = None
    if cfg.use_physical_sky:
        from voxelrt_torch.sky.atmos import prepare_sky

        sky = prepare_sky(
            cfg, ld.astype(np.float32),
            np.asarray(TEST_LIGHT_COLOR, np.float32) * cfg.light_weight,
            TEST_CONE_COS, quiet=True, device=device)
    tables = build_pallas_tables(world.material, arrays["voxels"],
                                 cfg.grid_res)
    if cfg.use_directional_light:
        tables = add_sun_open_table(tables, world.material, ld, TEST_CONE_COS)
    return SceneData(
        occ_words=_i32(arrays["occ_words"], device),
        voxels=_i32(arrays["voxels"], device),
        mat_params=MaterialList().params(device),
        sky=sky,
        tables=upload_tables(tables, device),
    )


def make_params(cfg: RenderConfig, device, camera_pos=(0.4, 0.5, 2.0),
                look_at=(0.0, 0.0, 0.0)) -> RenderParams:
    proj = perspective_matrix(cfg.fov, cfg.aspect_ratio, cfg.z_near, cfg.z_far)
    view = look_at_matrix(camera_pos, look_at, (0, 1, 0))
    light = np.array(TEST_LIGHT_DIR, np.float64)
    light /= np.linalg.norm(light)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return RenderParams(
        camera_pos=f32(camera_pos),
        proj=f32(proj),
        proj_inv=f32(np.linalg.inv(proj)),
        view=f32(view),
        view_inv=f32(np.linalg.inv(view)),
        prev_proj=f32(proj),
        prev_view=f32(view),
        prev_camera_pos=f32(camera_pos),
        light_direction=f32(light),
        light_cone_cos_theta_max=f32(TEST_CONE_COS),
        light_color=f32(TEST_LIGHT_COLOR),
        floor_height=f32(-0.1),
        floor_color=f32([0.8, 0.8, 0.85]),
        floor_material=torch.tensor(1, dtype=torch.int32, device=device),
        background_color=f32([0.2, 0.3, 0.5]),
        max_accum_frames=f32(1e9),
        taa_jitter=f32(np.zeros(2)),
        frame_idx=torch.tensor(0, dtype=torch.int32, device=device),
        voxel_edges=f32(cfg.voxel_edges),
    )
