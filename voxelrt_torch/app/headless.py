"""Headless renderer: owns the device scene data, the render params, the
progressive accumulation loop (``render``) and the scripted camera-path
loop with the reference's motion policy (``run_frames``); the PyTorch port
of voxelrt/app/headless.py."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from voxelrt_torch import resolve_device
from voxelrt_torch.materials import MaterialList
from voxelrt_torch.ops import prng
from voxelrt_torch.ops.accel import add_sun_open_table, build_pallas_tables
from voxelrt_torch.ops.dda_kernel import upload_tables
from voxelrt_torch.render import pipeline
from voxelrt_torch.render.pathtracer import RenderParams, SceneData
from voxelrt_torch.utils.profiling import sync


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32).copy()).to(device)


class HeadlessRenderer:
    """``device=None`` renders on the CUDA card and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, cfg, scene, seed=0, quiet=False, device=None,
                 sky_cache_dir=".skycache"):
        self.device = resolve_device(device)
        self.sky_cache_dir = sky_cache_dir
        # voxel_edges/exposure are per-frame values (RenderParams), kept
        # out of the static config as in the JAX package.
        self._voxel_edges = float(cfg.voxel_edges)
        self._exposure = float(cfg.exposure)
        self.cfg = dataclasses.replace(cfg, voxel_edges=0.0, exposure=0.0)
        self.scene = scene
        self.quiet = quiet
        self.mats = MaterialList()
        self.key = prng.key(seed)
        self.state = None
        self.scene_data = None
        self._frame = 0
        self._rng = np.random.default_rng(seed ^ 0x5EED)
        self._prev = None  # (proj, view, camera_pos) of previous frame

    # -- precompute (renderer/pathtracer.py:314-323) -----------------------

    def prepare_data(self):
        sc = self.scene
        # Static set of material ids reachable at runtime and the Disney
        # features they use (headless.py:81-95).
        ids = set(int(i) for i in np.unique(sc.world.material))
        ids |= {0, 1, 2, int(sc._floor_material)}
        rows = self.mats.params_np[sorted(ids)]
        feats = tuple(bool(np.any(rows[:, c] != 0.0)) for c in (3, 4, 8, 9, 11))
        self.cfg = dataclasses.replace(
            self.cfg, material_ids=tuple(sorted(ids)), material_features=feats)
        arrays = sc.world.device_arrays()
        sky = None
        if self.cfg.use_physical_sky:
            from voxelrt_torch.sky.atmos import prepare_sky

            sky = prepare_sky(
                self.cfg,
                np.asarray(sc._light_direction, np.float32),
                np.asarray(sc._light_color, np.float32) * self.cfg.light_weight,
                float(sc._light_cone_cos_theta_max), quiet=self.quiet,
                cache_dir=self.sky_cache_dir,
                cloud_tex=getattr(sc, "_cloud_texture", None),
                device=self.device)
        tables = build_pallas_tables(sc.world.material, arrays["voxels"],
                                     self.cfg.grid_res)
        if self.cfg.use_directional_light:
            tables = add_sun_open_table(
                tables, sc.world.material,
                np.asarray(sc._light_direction, np.float64),
                float(sc._light_cone_cos_theta_max))
        # The 'auto' scheduling knobs resolve as in the JAX package
        # (headless.py:129-160) so configs stay one to one; the port's
        # kernel reads dda_nee_src_open and ignores dda_march_unroll.
        open_frac = 0.0
        if self.cfg.use_directional_light:
            w = np.asarray(tables.sun_open_words).astype(np.uint32)
            open_frac = float(np.unpackbits(w.view(np.uint8)).sum()) / max(
                (self.cfg.grid_res // 4) ** 3, 1)
        if self.cfg.dda_nee_src_open == "auto":
            self.cfg = dataclasses.replace(
                self.cfg, dda_nee_src_open="on" if open_frac >= 0.15 else "off")
        if self.cfg.dda_march_unroll == "auto":
            u = 2 if (self.cfg.use_directional_light and open_frac < 0.15) else 3
            self.cfg = dataclasses.replace(self.cfg, dda_march_unroll=u)
        self.scene_data = SceneData(
            occ_words=_i32(arrays["occ_words"], self.device),
            voxels=_i32(arrays["voxels"], self.device),
            mat_params=self.mats.params(self.device),
            sky=sky,
            tables=upload_tables(tables, self.device),
        )
        self.state = pipeline.init_state(self.cfg, self.device)
        self._frame = 0
        self._prev = None

    # -- per-frame params ---------------------------------------------------

    def _params(self, max_accum_frames):
        sc = self.scene
        dev = self.device
        proj, view = sc.camera.matrices(
            sc._fov, self.cfg.aspect_ratio, self.cfg.z_near, self.cfg.z_far)
        if self._prev is None:
            self._prev = (proj, view, np.asarray(sc.camera.position, np.float32))
        prev_proj, prev_view, prev_pos = self._prev
        jitter = (self._rng.random(2) * 2.0 - 1.0) / np.asarray(
            self.cfg.image_res, np.float64)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        p = RenderParams(
            camera_pos=f32(sc.camera.position),
            proj=f32(proj), proj_inv=f32(np.linalg.inv(proj)),
            view=f32(view), view_inv=f32(np.linalg.inv(view)),
            prev_proj=f32(prev_proj), prev_view=f32(prev_view),
            prev_camera_pos=f32(prev_pos),
            light_direction=f32(sc._light_direction),
            light_cone_cos_theta_max=f32(sc._light_cone_cos_theta_max),
            light_color=f32(sc._light_color),
            floor_height=f32(sc._floor_height),
            floor_color=f32(sc._floor_color),
            floor_material=torch.tensor(int(sc._floor_material),
                                        dtype=torch.int32, device=dev),
            background_color=f32(sc._background_color),
            max_accum_frames=f32(max_accum_frames),
            taa_jitter=f32(jitter),
            frame_idx=torch.tensor(self._frame, dtype=torch.int32, device=dev),
            voxel_edges=f32(self._voxel_edges),
        )
        self._copy_prev = (proj, view, np.asarray(sc.camera.position,
                                                  np.float32))
        return p

    def copy_prev_matrices(self):
        """renderer/pathtracer.py:283-287 (host-side)."""
        self._prev = self._copy_prev

    # -- static-camera progressive render ------------------------------------

    def render(self, spp=512, chunk=None, log_every=128,
               checkpoint_every=None, checkpoint_path=None, resume_from=None,
               stats=None):
        """Accumulate ``spp`` samples with the camera fixed, ``chunk``
        samples per accumulate_n call keyed by fold_in(key, frame) as in the
        JAX package; returns the tonemapped (W, H, 3) float image.

        Checkpoint/resume (utils/checkpoint.py, the JAX package's file
        format): with ``checkpoint_path`` and ``checkpoint_every`` the whole
        state, the RNG key and the frame and spp counters are saved after a
        chunk once ``checkpoint_every`` samples have run since the last save,
        and never after the last chunk; ``resume_from`` restores such a file
        and continues to ``spp`` samples in total. A resumed render gives the
        uninterrupted image exactly when both runs use the same ``chunk``.

        ``stats``: optional :class:`voxelrt_torch.utils.profiling.FrameStats`
        receiving one row per chunk."""
        chunk = chunk or max(1, min(spp, self.cfg.samples_per_launch * 8))
        params = self._params(max_accum_frames=999999999.0)
        done = 0
        if resume_from is not None:
            from voxelrt_torch.utils.checkpoint import load_render_state

            self.state, self.key, self._frame, extra = load_render_state(
                resume_from, self.state)
            done = int(extra.get("done", self._frame))
            if not self.quiet:
                print(f"  resumed at {done}/{spp} spp from {resume_from}")
        last_saved = done
        n_pixels = self.cfg.image_res[0] * self.cfg.image_res[1]
        t0 = time.perf_counter()
        while done < spp:
            n = min(chunk, spp - done)
            tc0 = time.perf_counter()
            self.state = pipeline.accumulate_n(
                self.cfg, self.scene_data, params, self.state,
                prng.fold_in(self.key, self._frame), False, 1.0, n)
            self._frame += n
            done += n
            if stats is not None:
                sync(self.device)
                # ≥2 traces (primary + NEE shadow) per bounce-capable sample
                stats.record(self._frame, done,
                             (time.perf_counter() - tc0) * 1e3,
                             n_rays=n * n_pixels * 2 * self.cfg.max_ray_depth,
                             quiet=self.quiet)
            if checkpoint_path and checkpoint_every and done < spp and (
                    done - last_saved >= checkpoint_every):
                from voxelrt_torch.utils.checkpoint import save_render_state

                save_render_state(checkpoint_path, self.state, self.key,
                                  self._frame, extra={"done": done})
                last_saved = done
            if not self.quiet and (done % log_every == 0 or done == spp):
                sync(self.device)
                print(f"  {done}/{spp} spp  ({time.perf_counter() - t0:.2f}s)")
        self.copy_prev_matrices()
        return self.fetch_image(render_scale=1.0)

    def fetch_image(self, render_scale=1.0):
        img = pipeline.fetch_image(self.cfg, self.state, self._exposure,
                                   render_scale)
        return img.cpu().numpy()

    # -- interactive-equivalent loop -----------------------------------------

    def run_frames(self, frames, spp_per_frame=1, on_frame=None, stats=None,
                   fetch_final=True, sync_lag=0):
        """Scripted camera-path loop with the reference's motion policy
        (scene.py:206-256): while moving → render_scale 0.5, history cap 50;
        transitions reset the framebuffer. ``frames`` is an iterable of
        dicts with optional ``move_keys``, ``orbit`` and ``dt``. ``stats``:
        optional :class:`voxelrt_torch.utils.profiling.FrameStats` receiving
        one row per frame. ``fetch_final=False`` skips the final image
        fetch (throughput loops sync elsewhere).

        ``sync_lag=N`` (with ``stats``) waits for frame ``i-N`` after
        dispatching frame ``i`` — double buffering at N=1: the display is
        one frame behind while the host prepares the next frame. Recorded
        ``wall_ms`` is then the time BETWEEN successive frame completions,
        not dispatch-to-sync. Ignored when ``on_frame`` forces a per-frame
        image fetch."""
        camera_is_moving = False
        img = None
        last_t = time.perf_counter()
        pending = []  # (frame_idx, spp, n_rays, moving, done event or None)
        last_sync_t = time.perf_counter()

        def _drain(to_len):
            nonlocal last_sync_t
            while len(pending) > to_len:
                fidx, n_spp, n_rays, mov, done = pending.pop(0)
                if done is not None:
                    done.synchronize()
                now = time.perf_counter()
                stats.record(fidx, n_spp, (now - last_sync_t) * 1e3,
                             n_rays=n_rays, quiet=self.quiet, moving=mov)
                last_sync_t = now

        for i, frame in enumerate(frames):
            dt = frame.get("dt")
            if dt is None:
                now = time.perf_counter()
                dt = now - last_t
                last_t = now
            moved = False
            if frame.get("move_keys"):
                moved |= self.scene.camera.translate(frame["move_keys"], dt)
            if frame.get("orbit"):
                moved |= self.scene.camera.orbit(*frame["orbit"])

            should_reset = moved != camera_is_moving
            camera_is_moving = moved
            max_accum = 50.0 if moved else 999999999.0
            render_scale = 0.5 if moved else 1.0

            if should_reset:
                self.state = pipeline.reset_framebuffer(self.state)

            params = self._params(max_accum_frames=max_accum)
            tf0 = time.perf_counter()
            self.state = pipeline.accumulate_n(
                self.cfg, self.scene_data, params, self.state,
                prng.fold_in(self.key, self._frame),
                camera_is_moving, render_scale, spp_per_frame)
            self._frame += spp_per_frame
            self.copy_prev_matrices()
            if stats is not None:
                w, h = self.cfg.image_res
                n_pix = int(w * render_scale) * int(h * render_scale)
                n_rays = spp_per_frame * n_pix * 2 * self.cfg.max_ray_depth
                if sync_lag > 0 and on_frame is None:
                    # An event recorded behind this frame's work completes
                    # when the frame does (on the CPU it already has).
                    done = None
                    if self.device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(self.device))
                    pending.append((self._frame, spp_per_frame, n_rays,
                                    camera_is_moving, done))
                    _drain(sync_lag)
                else:
                    sync(self.device)
                    stats.record(
                        self._frame, spp_per_frame,
                        (time.perf_counter() - tf0) * 1e3,
                        n_rays=n_rays, quiet=self.quiet,
                        moving=camera_is_moving)
            if on_frame is not None:
                img = self.fetch_image(render_scale)
                on_frame(i, img)
        if stats is not None and pending:
            _drain(0)
        if on_frame is None and fetch_final:
            img = self.fetch_image(1.0 if not camera_is_moving else 0.5)
        return img
