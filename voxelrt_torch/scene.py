"""Scene — the public user-facing API (the PyTorch port of voxelrt/scene.py).

Reproduces the reference's 8-method Scene surface (scene.py:112-297):
``set_voxel`` / ``get_voxel``, ``set_floor``, ``set_directional_light``,
``set_background_color``, ``set_use_physical_sky``, ``set_use_clouds`` and
``finish()`` — with TPU-native semantics: scene construction runs as
vectorized host numpy (the reference runs it inside user ``@ti.kernel``s;
our examples pass index *arrays* for the same effect), and ``finish()``
renders headlessly to PNG instead of opening a GGUI window. ``run_frames``
is the interactive loop's equivalent with a scripted camera path; the
browser viewer (app/viewer.py) drives it from keyboard and mouse input.

``Scene(..., device=None)`` renders on the CUDA card and raises when there is
none; ``device="cpu"`` runs the plain PyTorch path explicitly.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import datetime

import numpy as np

VOXEL_DX = 1.0 / 64.0  # scene.py:11
SCREEN_RES = (1280, 720)  # reference uses 1920×1080 (scene.py:12); see cfg
UP_DIR = (0, 1, 0)  # scene.py:13

HELP_MSG = """
====================================================
voxelrt_torch headless renderer (CUDA)
* scene.finish() renders progressively and writes a PNG
====================================================
"""


class Scene:
    def __init__(self, voxel_edges=0.06, exposure=3, image_res=None,
                 config=None, seed=0, quiet=False, device=None,
                 sky_cache_dir=".skycache"):
        """Mirrors scene.py:113-129. Extra kwargs: resolution, full
        RenderConfig override, RNG seed, torch device, and the directory
        where a computed physical sky is cached (and looked up first)."""
        from voxelrt_torch import resolve_device
        from voxelrt_torch.camera import Camera
        from voxelrt_torch.config import RenderConfig
        from voxelrt_torch.world import VoxelWorld

        self.device = resolve_device(device)
        self.sky_cache_dir = sky_cache_dir
        if config is None:
            config = RenderConfig(
                image_res=tuple(image_res) if image_res else SCREEN_RES,
                voxel_edges=float(voxel_edges),
                exposure=float(exposure),
            )
        self.config = config
        self.camera = Camera(up=UP_DIR)
        self.world = VoxelWorld(config.voxel_dx, config.grid_res, voxel_edges)
        self.seed = seed
        self.quiet = quiet
        if not quiet:
            print(HELP_MSG)

        # Runtime state mirroring the reference's 0-D fields.
        self._light_direction = np.array([1.0, 1.0, 1.0])
        self._light_direction /= np.linalg.norm(self._light_direction)
        self._light_cone_cos_theta_max = math.cos(0.1 * 0.5)
        self._light_color = np.zeros(3)  # default set at scene.py:127
        self._floor_height = 0.0
        self._floor_color = np.ones(3)
        self._floor_material = 1
        self._background_color = np.zeros(3)
        self._use_physical_sky = False
        self._use_clouds = False
        self._cloud_texture = None
        self._fov = config.fov

        self._renderer = None  # built lazily at finish()

    # ------------------------------------------------------------------
    # The 8-method reference API (scene.py:139-169)

    def set_voxel(self, idx, mat, color):
        """Accepts a single (3,) index or an (N, 3) batch (vectorized
        scene construction is the TPU-native replacement for device-side
        ``@ti.func`` calls)."""
        self.world.set_voxels(idx, mat, color)

    def get_voxel(self, idx):
        idx = np.asarray(idx, dtype=np.float64)
        single = idx.ndim == 1
        mat, color = self.world.get_voxels(np.atleast_2d(idx))
        if single:
            return int(mat[0]), color[0]
        return mat, color

    def set_floor(self, height, color, material=1):
        """scene.py:148-151."""
        self._floor_height = float(height)
        self._floor_color = np.asarray(color, dtype=np.float64)
        self._floor_material = int(material)

    def set_directional_light(self, direction, direction_noise, color):
        """scene.py:153-154, renderer/pathtracer.py:139-144."""
        d = np.asarray(direction, dtype=np.float64)
        self._light_direction = d / np.linalg.norm(d)
        self._light_cone_cos_theta_max = math.cos(direction_noise * 0.5)
        self._light_color = np.asarray(color, dtype=np.float64)

    def set_background_color(self, color):
        self._background_color = np.asarray(color, dtype=np.float64)

    def set_use_physical_sky(self, use):
        self._use_physical_sky = bool(use)

    def set_use_clouds(self, use):
        self._use_clouds = bool(use)

    def set_cloud_texture(self, texture):
        """Use a 256×256 RGB cloud texture for the physical sky's volumetric
        cloud layer instead of the built-in procedural field. Accepts an
        image path or a (256, 256, 3) array; u8 arrays are scaled to [0, 1].
        Channel semantics follow the reference
        (renderer/atmos.py:195-224): R = lower-band density, G = upper-band
        density, B = coverage, each thresholded at 0.7. Pass None to return
        to the procedural field."""
        if texture is None:
            self._cloud_texture = None
            return
        if isinstance(texture, (str, bytes)):
            from PIL import Image

            texture = np.asarray(Image.open(texture).convert("RGB"))
        tex = np.asarray(texture)
        if tex.dtype == np.uint8:
            tex = tex.astype(np.float32) / 255.0
        tex = tex.astype(np.float32)
        if tex.shape != (256, 256, 3):
            raise ValueError(
                f"cloud texture must be (256, 256, 3), got {tex.shape}"
            )
        self._cloud_texture = tex

    # ------------------------------------------------------------------

    @property
    def renderer(self):
        if self._renderer is None:
            from voxelrt_torch.app.headless import HeadlessRenderer

            cfg = dataclasses.replace(
                self.config,
                use_physical_sky=self._use_physical_sky,
                use_clouds=self._use_clouds,
            )
            self._renderer = HeadlessRenderer(cfg, self, seed=self.seed,
                                              quiet=self.quiet,
                                              device=self.device,
                                              sky_cache_dir=self.sky_cache_dir)
        return self._renderer

    def finish(self, spp=512, out_path=None, camera_pos=None, look_at=None,
               save=True):
        """Headless equivalent of scene.py:171-297: precompute (voxel bake,
        occupancy pyramid, sky LUT/skybox/clouds), progressively accumulate
        ``spp`` samples with a static camera, tonemap and write a PNG.

        Returns the (W, H, 3) float LDR image.
        """
        if camera_pos is not None or look_at is not None:
            self.camera.set_pose(
                camera_pos if camera_pos is not None else self.camera.position,
                look_at if look_at is not None else self.camera.look_at,
            )
        r = self.renderer
        r.prepare_data()
        img = r.render(spp=spp)
        if save:
            if out_path is None:
                os.makedirs("screenshot", exist_ok=True)
                stamp = datetime.today().strftime("%Y-%m-%d-%H%M%S")
                out_path = os.path.join("screenshot", f"render-{stamp}.png")
            from voxelrt_torch.utils.image import write_png

            write_png(out_path, img)
            if not self.quiet:
                print(f"Image written to {out_path}")
        return img

    def run_frames(self, frames, spp_per_frame=1, on_frame=None, stats=None,
                   fetch_final=True, sync_lag=0):
        """Interactive-equivalent loop with a scripted camera path
        (replaces the GGUI while-loop, scene.py:206-297).

        ``frames`` is an iterable of dicts; each may contain ``move_keys``
        (WASDQE characters), ``orbit`` (dx, dy), ``dt``. Motion triggers the
        reference's degradation policy: render_scale 0.5 + 50-frame history
        cap while moving, framebuffer reset on transitions
        (scene.py:209-228). Returns the last LDR image (None when
        ``fetch_final=False`` — throughput loops sync elsewhere).
        ``sync_lag=N`` double-buffers the per-frame sync (display N frames
        behind; see HeadlessRenderer.run_frames)."""
        r = self.renderer
        r.prepare_data()
        return r.run_frames(frames, spp_per_frame=spp_per_frame,
                            on_frame=on_frame, stats=stats,
                            fetch_final=fetch_final, sync_lag=sync_lag)
