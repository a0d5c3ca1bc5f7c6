"""Static render configuration (the PyTorch port's copy of voxelrt/config.py).

Same fields, same defaults and the same ``dda_march_unroll`` resolution as
the JAX package, so a config maps one to one. The port always runs the JAX
package's KERNEL path (``use_pallas_dda=True`` semantics, bf16-packed sky
words), on the card through the hand-written CUDA kernels and on the CPU
through their plain PyTorch twins, and takes the JAX package's route for
every mode of ``trace_sample``: ReSTIR-PT (``use_restir_pt``,
``restir_taps``, ``restir_radius``), the sorted traversal route
(``sort_rays``) and the threefry draw table (``rng_draws='table'``). Fields that only choose a
backend or schedule TPU work are kept for the one-to-one mapping and are
IGNORED by the port: ``use_pallas_dda``, ``pallas_interpret``,
``dda_block_rows``, ``dda_queue_depth``, ``dda_refill_every``,
``dda_march_unroll``, ``dda_fetch_cadence``, ``dda_resolve_steps``,
``sky_route_sort`` and ``sky_sort_sliced``. The JAX package documents each
of them as leaving per-ray results unchanged. The port's traversal kernel
reads the two sun-open knobs, ``dda_sun_mode`` and ``dda_nee_src_open``,
which leave per-ray results unchanged as well.

``use_pallas_dda`` is a routing decision: the JAX package traces with its
portable traversal (``ops/dda.py``) when it is False, its default, on the
CPU and the GPU, and with its kernel on a TPU. Routed that way the port's
default config would run no kernel on the card, so the port keeps ignoring
the flag and always traces with its kernel B1. Its own portable traversal,
``voxelrt_torch/ops/dda.py``, is B1's second oracle in the tests and on the
card, not a route of ``trace_sample``; the JAX package documents the two
routes as giving the same per-ray results.

The reference scatters configuration across three tiers: module constants
(``USE_RESTIR_PT``, ``MAX_RAY_DEPTH``, ``RADIANCE_CLAMP`` at
renderer/pathtracer.py:15-20; ``SCREEN_RES``/``VOXEL_DX`` at scene.py:11-12),
constructor arguments (``voxel_edges``, ``exposure``, scene.py:113) and 0-D
runtime fields (the Scene setter methods, scene.py:139-169).

Here everything that is *static at jit-trace time* lives in one frozen
dataclass; per-frame runtime values (camera, light, floor, flags that do not
change traced code shape) live in the :class:`voxelrt_torch.render.pathtracer.RenderParams`
instead.
"""

from __future__ import annotations

import dataclasses
import math
import os


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Trace-time-static renderer configuration."""

    # Image / screen (reference fixes 1920x1080 at scene.py:12; we default to
    # the 720p benchmark resolution and make it configurable).
    image_res: tuple[int, int] = (1280, 720)

    # Voxel grid (scene.py:11, renderer/voxel_world.py:13-14).
    grid_res: int = 128
    voxel_dx: float = 1.0 / 64.0

    # Scene constructor args (scene.py:113).
    voxel_edges: float = 0.06
    exposure: float = 3.0

    # Path tracing constants (renderer/pathtracer.py:15-24).
    max_ray_depth: int = 4
    use_directional_light: bool = True
    use_restir_pt: bool = False
    radiance_clamp: float = 300.0

    # ReSTIR spatial GRIS pass parameters (renderer/pathtracer.py:1312-1314).
    restir_radius: float = 24.0
    restir_taps: int = 32

    # NEE sun transmittance: the reference fetches the skybox transmittance
    # per cone-sampled light direction at every depth
    # (renderer/pathtracer.py:465-466). Across the NEE cone (example6:
    # half-angle 0.72°) the transmittance varies < 0.7% (max) / 0.2% (mean),
    # so the default evaluates it ONCE per launch at the cone centre —
    # removing a full-wavefront texture fetch per depth. 'per_ray' restores
    # the reference-exact behavior.
    nee_transmittance: str = "center"  # 'center' | 'per_ray'

    # IN-KERNEL NEE: the traversal kernel converts a retired primary/bounce
    # ray in place into its sun-cone shadow ray instead of the renderer
    # issuing a separate any-hit shadow dispatch per depth (``nee=`` of
    # ops/dda_kernel.raytrace). The JAX package tests equality with the
    # two-dispatch formulation. The port reads it: False runs a closest-hit
    # dispatch and a separate any-hit sun-shadow dispatch (B1's shadow mode)
    # per depth.
    nee_in_kernel: bool = True

    # Traversal bound (renderer/raytracer.py:103).
    max_dda_advances: int = 512

    # Traversal backend of the JAX package: its Pallas kernel
    # (ops/dda_pallas.py) or its portable XLA implementation (ops/dda.py);
    # `pallas_interpret` runs that kernel in interpreter mode. The port
    # accepts and ignores both: it always has the kernel path's semantics.
    use_pallas_dda: bool = False
    pallas_interpret: bool = False

    # Static set of material ids that can occur at runtime (voxel grid +
    # floor + built-ins), baked by HeadlessRenderer.prepare_data. A small
    # set turns the (N, 128) one-hot palette matmul in fetch_material into
    # an exact per-field select chain (see voxelrt/materials.py).
    material_ids: tuple = ()
    # Which Disney features the ids in material_ids actually use
    # (ops.bsdf.MatFeatures fields); features that are zero across the whole
    # palette subset let the BSDF drop exactly-zero lobes at trace time.
    # () = unknown -> evaluate everything.
    material_features: tuple = ()

    # Sort incoherent (bounce/shadow) rays by origin-cell morton code before
    # dispatching the traversal kernel, so that terminated lanes compact to
    # the back and live blocks become spatially tight. Default OFF in the
    # JAX package. The port reads it: True routes every non-primary
    # dispatch through render/pathtracer._trace_voxels_sorted (one sort of
    # the routing keys, B1 on the sorted rays, the outputs scattered back)
    # and turns in-kernel NEE off, as the JAX package does.
    sort_rays: bool = False

    # Rows of rays per block of the JAX package's traversal kernel (a
    # multiple of 8): a scheduling knob of that kernel, per-ray results do
    # not depend on it. The env override exists for the JAX package's
    # CPU-interpret tests, where wide blocks only pad tiny ray sets
    # (tests/conftest.py pins 8). The port accepts and ignores it (one
    # thread per ray).
    dda_block_rows: int = int(os.environ.get("VOXELRT_DDA_BLOCK_ROWS", "24"))

    # (The v4 kernel's dda_mask_group_words knob is gone: the v5 kernel's
    # mask fetch is one full static scan over the rank-compressed mixed-cell
    # table — see ops/accel.py — with no grouping machinery to tune.)

    # QUEUED WAVEFRONT of the JAX package's traversal kernel: each slot of
    # an incoherent dispatch (bounce/shadow) holds a queue of this many rays
    # and reloads in place as rays retire, amortizing lock-step straggler
    # pacing; 1 disables. `dda_refill_every` is the refill cadence in loop
    # iterations. Both schedule that kernel's work and leave per-ray results
    # unchanged; the port accepts and ignores them.
    dda_queue_depth: int = int(os.environ.get("VOXELRT_DDA_QUEUE", "32"))
    dda_refill_every: int = 2

    # Grid advances per loop iteration of the JAX package's traversal
    # kernel (march unroll), and its fetch cadence. Per-ray results are
    # bitwise identical at any value (rays at occupied cells just stall
    # until the next fetch round). 'auto' (the default) resolves by the same
    # sun-openness statistic that gates dda_nee_src_open
    # (app/headless.prepare_data): ≥15% sun-open cells ⇒ 3, else 2; callers
    # that construct RenderConfig directly without the app shell resolve
    # 'auto' to 3. The port resolves 'auto' the same way, so configs stay
    # one to one, and its kernel ignores the result.
    dda_march_unroll: object = "auto"  # 'auto' | int ≥ 1
    dda_fetch_cadence: int = 1

    # In-kernel-NEE sun-open early-out cadence: 'all' consults the
    # per-cell sun-escape certificate on every advance (the LOD2 gather
    # becomes a dual-table scan), 'half' only on the unrolled march
    # segments (halves the dual-gather cost; a certified shadow ray
    # retires ≤1 advance later — outputs identical), 'off' disables the
    # early-out. Pure scheduling knob; per-ray results are unchanged. The
    # port's kernel checks every advance under both 'all' and 'half': the
    # 'half' cadence halves a dual-table gather cost of the TPU kernel that
    # a per-thread table read on the card does not have, and the outputs
    # are identical.
    dda_sun_mode: str = "half"  # 'all' | 'half' | 'off'

    # In-cell DDA unroll length per fetch round (9 = the longest monotone
    # voxel path through a 4³ cell resolves in one fetch; shorter unrolls
    # run fewer mask tests per fetch but re-fetch rays that cross a cell
    # in more steps — the resolve is resumable either way, results exact).
    # The port accepts and ignores it.
    dda_resolve_steps: int = 9

    # Conversion-time sun-open retirement for in-kernel NEE shadow rays: a
    # converted shadow ray whose entry cell carries the sun-open
    # certificate (or whose AABB clip misses the grid) can be verdicted
    # 'visible' AT the refill itself — the slot loads its next queued ray
    # instead of marching the shadow for refill_every+ iterations. Bitwise
    # identical (the certificate guarantees the march could only end
    # 'visible'; equality test in tests/test_dda_pallas.py). 'auto'
    # resolves by the scene's sun-open cell fraction at setup (open scenes
    # on, enclosed interiors off). The port resolves 'auto' the same way and
    # its kernel applies the result.
    dda_nee_src_open: str = "auto"  # 'auto' | 'on' | 'off'

    # Escape-sky fetch estimator: 'stochastic' picks ONE bilinear corner
    # per sample with probability equal to its bilinear weight — unbiased
    # (the fetch is linear in texel values) and the same per-sample dither
    # role as the reference's random direction jitter, which at the
    # default 1024² skybox already spans ~1.75 texels. The fetch kernel
    # (B2) then reads one corner instead of four and returns the packed
    # texel words losslessly. 'bilinear' is the reference's jittered
    # 4-corner interpolation of both maps, over the whole wavefront through
    # the bilinear fetch kernel (B3).
    sky_fetch: str = "stochastic"  # 'stochastic' | 'bilinear'

    # Per-sample uniform draws: 'pcg3d' derives each draw slot by hashing
    # (pixel key lo, pixel key hi, slot) with PCG3D (Jarzynski & Olano,
    # JCGT 2020), with no (n_draws, N) table. 'table' is the JAX package's
    # vmapped-threefry draw table (the per-pixel BASE key stays threefry
    # fold_in(sample key, pixel id) either way, so both modes are
    # shard-invariant counter-based RNG); the port builds that table on the
    # rays' device (render/pathtracer.draw_table), bit-equal to the JAX
    # package's.
    rng_draws: str = "pcg3d"  # 'pcg3d' | 'table'

    # Deferred-escape skybox fetch routing of the JAX package: True sorts
    # the wavefront's escape texel ids before its fetch kernel; False
    # dispatches the fetch in ray order. Identical results — purely a
    # routing choice. The port accepts and ignores it (B2 fetches in ray
    # order).
    sky_route_sort: bool = True

    # Slice the JAX package's escape-sky route/unroute sorts per sample,
    # with bitwise-identical output (exact per-lane fetch; per-slice unroute
    # is a permutation). 'auto' (default) slices when the wavefront exceeds
    # 24M lanes; True/'on' and False/'off' force it. The port accepts and
    # ignores it (it does not sort).
    sky_sort_sliced: object = "auto"  # 'auto' | True/'on' | False/'off'

    # Motion-phase reprojection backend: 'pallas' fuses the current-color
    # bilinear + gated history taps into one kernel (ops/resample.py, B4)
    # over bf16-packed sources (≈0.4% relative); 'xla' keeps the plain
    # float32 gather formulation, which both packages also take when the
    # active region exceeds 530,000 texels. Motion history caps at 50
    # frames and resets on stop, so converged stills are unaffected. The
    # port reads it (render/temporal._moving_taps).
    motion_resample: str = "pallas"  # 'pallas' | 'xla'

    # Vignette (renderer/pathtracer.py:32-34).
    vignette_strength: float = 0.9
    vignette_radius: float = 0.0
    vignette_center: tuple[float, float] = (0.5, 0.5)

    # Default vertical FOV in radians (renderer/pathtracer.py:89).
    fov: float = math.radians(50.0)

    # Camera near/far planes (scene.py:190-191).
    z_near: float = 0.01
    z_far: float = 10.0

    # Physical sky: static toggles — the reference stores them in 0-D fields
    # (scene.py:159-169) but they gate whole pipelines, so they are
    # trace-static here. The skybox resolution is 3840 in the reference
    # (renderer/atmos.py:66-67); it is configurable here to trade
    # precompute time and memory for fidelity.
    use_physical_sky: bool = False
    use_clouds: bool = False
    skybox_res: int = 1024
    trans_lut_res: tuple[int, int] = (256, 128)
    sky_steps: int = 64
    sky_sun_samples: int = 8
    sky_ms_samples: int = 8
    sky_ms_steps: int = 5
    cloud_steps: int = 32
    cloud_sun_samples: int = 8
    cloud_shadow_steps: int = 8
    cloud_accum_passes: int = 32

    # Reprojected-history tap filter while the camera moves: 'catmullrom'
    # (the reference's 4×4, renderer/pathtracer.py:1092-1183, the default)
    # or 'bilinear' (2×2). Converged still images are identical either way
    # (motion history caps at 50 and resets on stop). The port reads it.
    motion_filter: str = "catmullrom"

    # Number of path samples traced per accumulate() call per pixel.
    samples_per_launch: int = 1

    # Light brightness multiplier (renderer/pathtracer.py:144).
    light_weight: float = 3.0

    @property
    def n_lods(self) -> int:
        return int(math.log2(self.grid_res))

    @property
    def aspect_ratio(self) -> float:
        return self.image_res[0] / self.image_res[1]

    @property
    def voxel_inv_dx(self) -> float:
        return 1.0 / self.voxel_dx

    @property
    def grid_offset(self) -> int:
        # renderer/voxel_world.py:14 — grid centered at the origin.
        return -(self.grid_res // 2)
