"""PyTorch port: the golden images of tests/test_golden.py, rendered by the
port, and the full-width goldens that ``chip_smoke.py`` holds the card to,
with the JAX package's functions that make them.

* ``main`` and ``lit_blocks`` are built through the port's ``Scene(...,
  device="cpu")`` with the calls and seed (7) of tests/test_golden.py,
  rendered at 24 spp and 96×54, and compared with the JAX package's goldens
  ``tests/golden/main.png`` and ``lit_blocks.png`` at that test's bar, RMSE
  < 0.02. ``lit_blocks`` is the one golden with a metal block (material 51)
  and an emissive pillar (material 11). Each is also held to the JAX
  package's render of the same scene today at RMSE 1e-4, the repo's bar
  for images against the JAX package: the goldens read 0.0045 and 0.0076
  on both packages alike, so that gap is the goldens', not the port's.
* ``tests/golden/torch_fullres/example6_1280x720_16spp.png`` is example6,
  unedited, rendered by the JAX package on the CPU at its default
  ``RenderConfig`` (1280×720) with ``samples_per_launch=16``: one launch of
  16 samples from the ``Scene``'s default seed, the sky loaded from the
  shipped ``data/skycache/`` file. ``chip_smoke.py`` phase 29 renders the
  same on the card and holds it to this file at RMSE 0.015, the bar of
  tests/test_examples_golden.py. Here the file is only read: a 720-row,
  1280-column RGB image. What separates the card's image from it beyond a
  few pixels is the sky maps' bf16 packing, which a 128×72 render shows
  here. Remake it (about 4 minutes and 12 GB of host
  memory) with:

      python tests/test_torch_golden.py --regen still

* ``example6_path_f24.png`` and ``example6_path_f30.png`` are frames 24 (the
  last moving one: 640×360 active, B4's Catmull-Rom taps, upsampled) and
  30 (the last still one after the reset) of example6's camera path, the
  path of ``chip_smoke.py`` phase 9 (24 frames of orbit (0.01, 0.002) +
  'w' at dt 0.02, then 6 still ones, one sample a frame), rendered through
  the JAX package's ``Scene.run_frames`` at the default ``RenderConfig``
  (1280×720) from the default seed. ``example6_restir_1280x720_4spp.png``
  is example6 with ReSTIR-PT at the JAX defaults (32 taps of radius 24,
  one sample a launch), 4 spp from the default seed through
  ``Scene.finish``. Both take the port's route, the JAX package's
  ``use_pallas_dda=True`` with its Pallas kernels in interpret mode
  (``PORT_ROUTE``): bf16 sky maps, B4 on bf16 motion sources, the Pallas
  traversal. Phases 30 and 31 hold the card to them at RMSE 0.015;
  tests/test_torch_golden_paths.py reads them and runs the functions below
  at 128×72 against the port's CPU path. Remake them (793 and 661 s and
  6.3 and 5.8 GiB of host memory on an 8-core host, the two side by side)
  with:

      python tests/test_torch_golden.py --regen path
      python tests/test_torch_golden.py --regen restir

  ``--regen path --frames 1,2,24 --out DIR`` writes other frames of the
  path as ``DIR/fNN.png`` instead (``tools/path_frames_torch.py compare``
  reads them).
* ``example6_sky_128.npz`` and ``example6_sky_16.npz`` are example6's sky
  computed by the JAX package's ``prepare_sky`` on the CPU at the default
  knobs of its ``RenderConfig`` (64 sky steps, 8 sun samples, 8×5
  multi-scatter, 32 cloud steps × 8 sun samples × 8 shadow steps × 32
  accumulation passes) with only ``skybox_res`` cut: the ``sky_<key>.npz``
  the JAX package writes, kept as it wrote it. Each chunk of texels draws
  from its own key, so every texel does the full default work; 128² is one
  chunk of 16,384 texels, the full sky's chunk size. ``example6_sky_<res>.json``
  beside each records the knobs, the light, the key and the seconds it
  took. ``chip_smoke.py`` phase 32 holds the card's sky to the 128² file
  and renders with both; tests/test_torch_sky_golden.py holds the port's
  CPU sky to the 16² one. Remake both (XLA compiles the 32 unrolled
  passes anew for each size: 1,096 s for 128² and 818 s for 16² on an
  8-core x86 host, 8 GB of host memory; start it in the background) with:

      python tests/test_torch_golden.py --regen sky

* ``example6_1920x1080_16spp.png`` and ``example6_path_1080p_f24.png`` /
  ``_f30.png`` are the still golden and the camera path's at the
  reference's own resolution (``REF_RES``), on the same routes and seed;
  ``example7_sky_128.npz`` is example7's low-sun sky made as example6's
  128² sky is. ``chip_smoke.py`` phases 34 and 16 hold the card to them;
  tests/test_torch_golden_refres.py reads them. Remake them (796 s and
  25.4 GiB, 2,887 s and 7.3 GiB, and 1,493 s and 7.9 GiB of host memory,
  side by side on an 8-core x86 host) with:

      python tests/test_torch_golden.py --regen still --res 1920x1080
      python tests/test_torch_golden.py --regen path --res 1920x1080
      python tests/test_torch_golden.py --regen sky example7

* ``<name>_1280x720_16spp.png`` for the ten other examples (``EXAMPLES``)
  and ``example2_restir_1280x720_4spp.png``, with ``example7_sky_tiny.npz``
  and ``example10_sky_tiny.npz``, are made by ``render_example_jax`` on
  the JAX package's CPU default route (``JAX_CPU_ROUTE``); what they are
  and how they are held is in tests/test_torch_golden_examples.py. Remake
  them (83-628 s a scene and 2.7-12.8 GiB of host memory each, about 25
  minutes for all on an 8-core x86 host two at a time) with:

      python tests/test_torch_golden.py --regen examples [NAME ...] --jobs 2

  ``--gap NAME [--route port]`` prints where the port's CPU render of an
  example at 128x72 parts from the JAX package's (``example_gap``):
  each pixel beyond 1e-4 with the samples that part and their closest hits
  up to the first that differs, and every lane on which the port's
  traversal returned a two-axis normal.
"""

import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_examples_golden import TINY_SKY  # noqa: E402

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, "golden")
FULLRES = os.path.join(GOLDEN_DIR, "torch_fullres",
                       "example6_1280x720_16spp.png")
FULLRES_RES = (1280, 720)
FULLRES_SPL = 16
# chip_smoke.py's camera path: 24 frames of orbit and dolly, then 6 still
MOVE = {"orbit": (0.01, 0.002), "move_keys": ["w"], "dt": 0.02}
HOLD = {"dt": 0.02}
PATH_FRAMES = [MOVE] * 24 + [HOLD] * 6
PATH_KEEP = (24, 30)  # the last moving frame and the last still one
PATH_RECORD = dict(moving=24, move=MOVE, still=6, hold=HOLD)
PATH_GOLDENS = {n: os.path.join(GOLDEN_DIR, "torch_fullres",
                                f"example6_path_f{n}.png") for n in PATH_KEEP}
# The reference's own resolution (scene.py's default image_res): the still
# and the camera path again, on the same routes and seed as at 1280×720.
REF_RES = (1920, 1080)
RESTIR_SPP = 4
RESTIR_GOLDEN = os.path.join(GOLDEN_DIR, "torch_fullres",
                             "example6_restir_1280x720_4spp.png")
# The JAX package's Pallas route with its kernels in interpret mode: the
# route the port always takes (bf16 sky maps, B4's taps on bf16 sources).
PORT_ROUTE = dict(use_pallas_dda=True, pallas_interpret=True)
SKY_RES = (128, 16)  # the card's golden, the CPU test's
SKY_GOLDENS = {r: os.path.join(GOLDEN_DIR, "torch_fullres",
                               f"example6_sky_{r}.npz") for r in SKY_RES}
SKY_KNOBS = ("skybox_res", "sky_steps", "sky_sun_samples", "sky_ms_samples",
             "sky_ms_steps", "cloud_steps", "cloud_sun_samples",
             "cloud_shadow_steps", "cloud_accum_passes", "use_clouds")
RES = (96, 54)
SPP = 24
# The ten example scenes besides example6, each at its default config with
# 16 samples in one launch, and example2 with ReSTIR-PT at 4 spp; the two
# sky scenes render from their TINY_SKY sky, made by the JAX package and
# shipped beside their goldens.
EXAMPLES = ("main",) + tuple(f"example{i}" for i in (1, 2, 3, 4, 5, 7, 8, 9,
                                                      10))
EXAMPLE_SKIES = ("example7", "example10")
RESTIR_EXAMPLE = "example2_restir"
JAX_CPU_ROUTE = ("the JAX package's CPU default route: use_pallas_dda=False "
                 "(the portable traversal ops/dda.py, the explicit shadow "
                 "dispatch, float32 sky maps)")


def _build_scenes():
    """tests/test_golden.py's scenes, on the port's CPU path."""
    from voxelrt_torch.scene import Scene

    scenes = {}

    s = Scene(exposure=10, image_res=RES, quiet=True, seed=7, device="cpu")
    s.set_floor(-0.05, (1.0, 1.0, 1.0))
    s.set_background_color((1.0, 0, 0))
    s.set_voxel((0, 0, 0), 2, (0.9, 0.1, 0.1))
    scenes["main"] = s

    s = Scene(exposure=3, image_res=RES, quiet=True, seed=7, device="cpu")
    s.set_floor(-0.05, (0.6, 0.7, 0.9))
    s.set_directional_light((1, 1, -1), 0.1, (1.0, 0.95, 0.9))
    s.set_background_color((0.2, 0.3, 0.5))
    ii, jj = np.meshgrid(np.arange(-10, 10), np.arange(-10, 10), indexing="ij")
    idx = np.stack([ii.ravel(), np.zeros(ii.size, int), jj.ravel()], -1)
    s.set_voxel(idx, 1, np.array([0.8, 0.5, 0.3]))
    for k in range(6):
        s.set_voxel((3, k + 1, 2), 51, (0.9, 0.9, 0.95))
        s.set_voxel((-4, k + 1, -3), 2 if k == 5 else 11, (1.0, 0.9, 0.6))
    scenes["lit_blocks"] = s
    return scenes


def still_golden(res=FULLRES_RES):
    """The full-width still golden of example6 at ``res``."""
    if tuple(res) == FULLRES_RES:
        return FULLRES
    w, h = res
    return os.path.join(GOLDEN_DIR, "torch_fullres",
                        f"example6_{w}x{h}_{FULLRES_SPL}spp.png")


def path_golden(n, res=FULLRES_RES):
    """The golden of frame ``n`` of example6's camera path at ``res``."""
    if tuple(res) == FULLRES_RES:
        return PATH_GOLDENS[n]
    return os.path.join(GOLDEN_DIR, "torch_fullres",
                        f"example6_path_{res[1]}p_f{n}.png")


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("name", ["main", "lit_blocks"])
def test_golden(name):
    import test_golden as jgolden
    from voxelrt_torch.utils.image import read_png

    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    img = _build_scenes()[name].finish(spp=SPP, save=False)
    assert img.shape == golden.shape and np.isfinite(img).all()
    rmse = _rmse(img, golden)
    # The JAX package's own render of the scene today: the port must sit
    # on it (the repo's bar for images against the JAX package, 1e-4), so
    # that what separates the port from the golden is the golden's.
    ref = np.asarray(jgolden._build_scenes()[name].finish(spp=SPP,
                                                          save=False))
    print(f"{name}: RMSE {rmse:.5f} against the golden; the JAX package's "
          f"render {_rmse(ref, golden):.5f} against it and "
          f"{_rmse(img, ref):.2e} against the port's")
    assert _rmse(img, ref) < 1e-4
    assert rmse < 0.02, f"{name}: RMSE {rmse}"


def test_fullres_golden_reads_as_an_image():
    """The full-width golden is a 720×1280 RGB PNG, read as the (W, H, 3)
    image the port's ``Scene.finish`` returns; no render."""
    from voxelrt_torch.utils.image import read_png

    with open(FULLRES, "rb") as fh:
        head = fh.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")
    assert (w, h) == FULLRES_RES
    img = read_png(FULLRES)
    assert img.shape == FULLRES_RES + (3,) and img.dtype == np.float32
    rows = img[::-1].transpose(1, 0, 2)
    assert rows.shape == (720, 1280, 3)
    # a lit frame with sky, terrain and shadow, not a constant
    assert 0.05 < img.mean() < 0.95 and img.std() > 0.05


@contextlib.contextmanager
def example_jax(name, shipped_sky=False, **config_over):
    """The JAX package's ``Scene`` of ``examples/<name>.py`` on the CPU,
    unedited, with ``config_over`` replacing fields of its
    ``RenderConfig``. The caller renders inside the ``with`` block, which
    runs in an empty working directory, so a sky can come only from
    ``data/skycache/`` or, with ``shipped_sky``, from the example's shipped
    sky golden, put in the directory's ``.skycache/`` by
    ``chip_smoke.shipped_sky``: a recomputed sky would be written to that
    cache, and that fails."""
    import dataclasses
    import importlib

    import jax

    jax.config.update("jax_platforms", "cpu")
    for d in (ROOT, os.path.join(ROOT, "examples")):
        if d not in sys.path:
            sys.path.insert(0, d)
    sys.modules.pop(name, None)
    argv = sys.argv
    sys.argv = [name]  # an example reads --res from the command line
    try:
        mod = importlib.import_module(name)
        if hasattr(mod, "initialize_voxels"):
            mod.initialize_voxels()
        else:
            mod.initialize()
            if hasattr(mod, "draw"):
                mod.draw()
        scene = mod.scene
        scene.config = dataclasses.replace(scene.config, **config_over)
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            cache = os.path.join(tmp, ".skycache")
            shipped = []
            if shipped_sky:
                from chip_smoke import shipped_sky as put_sky

                os.makedirs(cache)
                shipped = [put_sky(name, cache)]
            os.chdir(tmp)
            try:
                yield scene
            finally:
                os.chdir(cwd)
            if (sorted(os.listdir(cache)) if os.path.isdir(cache)
                    else []) != shipped:
                raise RuntimeError(f"{name}: the sky was recomputed, not "
                                   "loaded")
    finally:
        sys.argv = argv
        sys.modules.pop(name, None)


def render_example6_jax(res):
    """example6 through the JAX package's ``Scene`` on the CPU at ``res``,
    16 samples in one launch, as the module's docstring says."""
    with example_jax("example6", image_res=tuple(res),
                     samples_per_launch=FULLRES_SPL) as scene:
        return np.asarray(scene.finish(spp=FULLRES_SPL, save=False))


def render_example6_path_jax(res, frames=PATH_FRAMES, keep=PATH_KEEP):
    """example6's camera path through the JAX package's
    ``Scene.run_frames`` on the CPU at ``res`` and its default config
    otherwise, on the port's route (``PORT_ROUTE``), one sample a frame;
    returns {frame number counted from 1: image} for the frames in
    ``keep``."""
    imgs = {}

    def on_frame(i, img):
        if i + 1 in keep:
            imgs[i + 1] = np.asarray(img)

    with example_jax("example6", image_res=tuple(res),
                     **PORT_ROUTE) as scene:
        scene.run_frames([dict(f) for f in frames], on_frame=on_frame)
    return imgs


def render_example6_restir_jax(res, spp=RESTIR_SPP):
    """example6 with ReSTIR-PT at the JAX defaults (32 taps of radius 24,
    one sample a launch) through the JAX package's ``Scene.finish`` on the
    CPU at ``res``, ``spp`` samples from the default seed, on the port's
    route (``PORT_ROUTE``)."""
    with example_jax("example6", image_res=tuple(res), use_restir_pt=True,
                     **PORT_ROUTE) as scene:
        return np.asarray(scene.finish(spp=spp, save=False))


def example_golden(name):
    """The full-width golden of ``name`` (one of ``EXAMPLES`` or
    ``RESTIR_EXAMPLE``)."""
    return os.path.join(GOLDEN_DIR, "torch_fullres",
                        f"{name}_1280x720_{example_spp(name)}spp.png")


def example_sky_golden(name):
    """The shipped TINY_SKY sky of the sky scene ``name``."""
    return os.path.join(GOLDEN_DIR, "torch_fullres", f"{name}_sky_tiny.npz")


def example_spp(name):
    return RESTIR_SPP if name.endswith("_restir") else FULLRES_SPL


def example_config(name, **over):
    """(The example that ``name`` renders, the ``RenderConfig`` fields its
    golden changes besides ``image_res``, then ``over``): 16 samples in one
    launch, or ReSTIR-PT at the JAX defaults (32 taps of radius 24, one
    sample a launch) for ``RESTIR_EXAMPLE``; the TINY_SKY knobs for a sky
    scene."""
    base = name.removesuffix("_restir")
    config = (dict(use_restir_pt=True) if name != base
              else dict(samples_per_launch=FULLRES_SPL))
    if base in EXAMPLE_SKIES:
        config.update(TINY_SKY)
    return base, {**config, **over}


def render_example_jax(name, res, record=None, **over):
    """The golden of ``name`` rendered by the JAX package's ``Scene`` on
    the CPU at ``res``, on its CPU default route (``JAX_CPU_ROUTE``), from
    the Scene's default seed, with ``example_config``'s fields and
    ``over``; a sky scene renders from its shipped sky golden. The render
    is ``Scene.finish`` of ``example_spp(name)`` samples. ``record``, a
    dict, gets the example, the fields, the seed and the sky file."""
    base, config = example_config(name, **over)
    sky = base in EXAMPLE_SKIES
    with example_jax(base, sky, image_res=tuple(res), **config) as scene:
        if record is not None:
            record.update(example=base, res=list(res), spp=example_spp(name),
                          config=config, route=JAX_CPU_ROUTE,
                          seed=scene.seed, sky=os.path.basename(
                              example_sky_golden(base)) if sky else None)
        return np.asarray(scene.finish(spp=example_spp(name), save=False))


def render_example_port(name, res, **over):
    """The port's render of ``name`` on the CPU at ``res``, as its golden
    is made: ``example_config``'s fields and ``over``, a sky scene lit by
    its shipped sky from a temporary cache (which must then hold only
    it)."""
    from chip_smoke import shipped_sky
    from voxelrt_torch.app.examples import build_example

    base, config = example_config(name, **over)
    with tempfile.TemporaryDirectory() as cache:
        shipped = ([shipped_sky(base, cache)] if base in EXAMPLE_SKIES
                   else [])
        img = build_example(base, "cpu", res, sky_cache_dir=cache,
                            **config).finish(spp=example_spp(name),
                                             save=False)
        if sorted(os.listdir(cache)) != shipped:
            raise RuntimeError(f"{name}: the sky was recomputed")
    return np.asarray(img)


def sky_args(scene):
    """The light that HeadlessRenderer.prepare_data gives prepare_sky (the
    same attributes in both packages' ``Scene``)."""
    return (np.asarray(scene._light_direction, np.float32),
            np.asarray(scene._light_color, np.float32)
            * scene.renderer.cfg.light_weight,
            float(scene._light_cone_cos_theta_max))


def sky_record(res):
    """The record beside the sky golden of ``skybox_res`` ``res``."""
    with open(SKY_GOLDENS[res][:-len(".npz")] + ".json") as fh:
        return json.load(fh)


def make_sky_golden_jax(res, name="example6", **knobs):
    """The sky of example ``name`` through the JAX package's unedited
    ``prepare_sky`` on the CPU, at the example's ``RenderConfig`` with
    ``skybox_res`` = ``res`` and ``knobs`` and the scene's own light, into
    an empty cache directory; returns (the bytes of the ``sky_<key>.npz``
    it wrote, the record: knobs, light, key, seconds). Nothing may be
    written to ``data/skycache/`` or the repository's ``.skycache/``."""
    import time

    from voxelrt.sky import atmos as jatmos

    watched = [os.path.join(ROOT, "data", "skycache"),
               os.path.join(ROOT, ".skycache")]

    def listing():
        return {d: sorted(os.listdir(d)) if os.path.isdir(d) else None
                for d in watched}

    before = listing()
    with example_jax(name, skybox_res=res, **knobs) as scene, \
            tempfile.TemporaryDirectory() as cache:
        cfg = scene.renderer.cfg
        args = sky_args(scene)
        if getattr(scene, "_cloud_texture", None) is not None:
            raise RuntimeError(f"{name} has no cloud texture")
        t0 = time.perf_counter()
        jatmos.prepare_sky(cfg, *args, quiet=True, cache_dir=cache)
        seconds = time.perf_counter() - t0
        key = jatmos._cache_key(cfg, *args)
        (written,) = os.listdir(cache)
        if written != f"sky_{key}.npz":
            raise RuntimeError(f"the JAX package wrote {written}, not "
                               f"sky_{key}.npz")
        with open(os.path.join(cache, written), "rb") as fh:
            data = fh.read()
    if listing() != before:
        raise RuntimeError("the sky precompute wrote into the repository's "
                           "sky caches")
    record = dict(skybox_res=res, knobs={k: getattr(cfg, k)
                                         for k in SKY_KNOBS},
                  sun_dir=args[0].tolist(), sun_col=args[1].tolist(),
                  cos_max=args[2], seed=1234, key=key, seconds=seconds)
    if name != "example6":
        record["example"] = name
    return data, record


def test_example6_gap_is_the_bf16_sky_maps(monkeypatch):
    """What separates the port's example6 from the full-width golden beyond
    a few pixels, shown at 128×72 on the CPU with 16 samples in one launch:
    the port reads the sky maps bf16-packed (B2 and B3, the JAX package's
    route under ``use_pallas_dda``, its TPU default), where the JAX package
    on the CPU reads them as float32. With the JAX package's maps rounded
    to bf16 as ``pack_rgb_bf16`` rounds them (to nearest even), the port's
    image must sit on it: RMSE < 1e-4 and 99.9% of pixels within 1e-4
    (measured 1.2e-5 and 99.97%, no 8-bit value apart). Against the JAX
    package's own CPU route the RMSE must be at least 5 times that
    (measured 1.6e-4, 14%, of pixels within 1e-4, 3.4% of 8-bit values
    apart)."""
    from voxelrt.sky import atmos as jatmos
    from voxelrt_torch.app.examples import build_example

    res = (128, 72)
    port = build_example("example6", "cpu", res,
                         samples_per_launch=FULLRES_SPL).finish(
        spp=FULLRES_SPL, save=False)
    f32 = render_example6_jax(res)
    prepare = jatmos.prepare_sky

    def prepare_bf16(*args, **kwargs):
        sky = prepare(*args, **kwargs)

        def bf16(x):
            b = np.asarray(x, np.float32).view(np.uint32)
            b = ((b + ((b >> 16) & 1) + np.uint32(0x7FFF)) >> 16) << 16
            return b.view(np.float32)

        return sky._replace(
            skybox_scattering=bf16(sky.skybox_scattering),
            skybox_transmittance=bf16(sky.skybox_transmittance))

    monkeypatch.setattr(jatmos, "prepare_sky", prepare_bf16)
    bf = render_example6_jax(res)
    from voxelrt_torch.utils.image import to_uint8_rows

    refs = {"f32": f32, "bf16": bf}
    rmse = {k: _rmse(port, v) for k, v in refs.items()}
    near = {k: float((np.abs(port - v).max(-1) <= 1e-4).mean())
            for k, v in refs.items()}
    apart = {k: float((to_uint8_rows(port) != to_uint8_rows(v)).mean())
             for k, v in refs.items()}
    print(f"example6 {res}: RMSE {rmse}, share of pixels within 1e-4 "
          f"{near}, share of 8-bit values apart {apart}")
    assert rmse["bf16"] < 1e-4 and near["bf16"] >= 0.999
    assert rmse["f32"] >= 5 * rmse["bf16"]


def sky_golden(res, name="example6"):
    """The sky golden of example ``name`` at ``skybox_res`` ``res``."""
    return os.path.join(GOLDEN_DIR, "torch_fullres", f"{name}_sky_{res}.npz")


def regen_sky(sizes=SKY_RES, name="example6"):
    """Make the sky goldens of example ``name`` at the ``skybox_res`` in
    ``sizes``, every other knob at its default, one after the other, and
    write each with its record as soon as it is made."""
    import resource

    for res in sizes:
        data, record = make_sky_golden_jax(res, name)
        record["peak_host_gib"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
        path = sky_golden(res, name)
        with open(path, "wb") as fh:
            fh.write(data)
        with open(path[:-len(".npz")] + ".json", "w") as fh:
            json.dump(record, fh, indent=1)
            fh.write("\n")
        print(f"wrote {path}: {len(data)} bytes, key {record['key']}, "
              f"{record['seconds']:.1f} s, peak host memory "
              f"{record['peak_host_gib']:.2f} GiB", flush=True)


def _write_json(path, record):
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")


def regen_examples(names, jobs=1):
    """Make the full-width goldens of ``names`` (of ``EXAMPLES`` and
    ``RESTIR_EXAMPLE``): several in child processes, ``jobs`` at a time,
    so that each record's peak host memory is its own; one here. A sky
    scene's TINY_SKY sky is made first, written as
    ``example_sky_golden(name)`` with its record, and the golden rendered
    from it. Each golden gets a ``.json`` beside it: the route, the config
    fields, the seed, the seconds of the render and the peak host
    memory."""
    import resource
    import subprocess
    import time

    from voxelrt.utils.image import write_png

    if len(names) > 1:
        running, done = [], []
        for name in names:
            while len(running) >= jobs:
                time.sleep(1)
                done += [p for p in running if p.poll() is not None]
                running = [p for p in running if p.returncode is None]
            running.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--regen",
                 "examples", name]))
        for p in running:
            p.wait()
        failed = [p.args[-1] for p in done + running if p.returncode]
        if failed:
            raise SystemExit(f"the goldens of {failed} failed")
        return
    (name,) = names
    base = name.removesuffix("_restir")
    if base in EXAMPLE_SKIES and name == base:
        knobs = {k: v for k, v in TINY_SKY.items() if k != "skybox_res"}
        data, record = make_sky_golden_jax(TINY_SKY["skybox_res"], base,
                                           **knobs)
        record["peak_host_gib"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
        path = example_sky_golden(base)
        with open(path, "wb") as fh:
            fh.write(data)
        _write_json(path[:-len(".npz")] + ".json", record)
        print(f"wrote {path}: {len(data)} bytes, key {record['key']}, "
              f"{record['seconds']:.1f} s", flush=True)
    record = {}
    t0 = time.perf_counter()
    img = render_example_jax(name, FULLRES_RES, record=record)
    record.update(seconds=time.perf_counter() - t0, peak_host_gib=(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20))
    path = example_golden(name)
    write_png(path, img)
    record["bytes"] = os.path.getsize(path)
    _write_json(path[:-len(".png")] + ".json", record)
    print(f"wrote {path}: {record['bytes']} bytes, mean {img.mean():.4f}, "
          f"render {record['seconds']:.1f} s, peak host memory "
          f"{record['peak_host_gib']:.2f} GiB", flush=True)


GAP_RES = (128, 72)  # the size at which example_gap compares


def _hit_record(closest, normal, mat, mask):
    """One traversal dispatch's closest hits, a row a lane, as numpy."""
    return dict(mask=np.asarray(mask), closest=np.asarray(closest),
                normal=np.stack([np.asarray(c) for c in normal], -1),
                mat=np.asarray(mat))


@contextlib.contextmanager
def port_hits():
    """While open, each of the port's non-shadow ``next_hit`` dispatches
    appends its hits (``_hit_record``) to the list this yields."""
    from voxelrt_torch.render import pathtracer as ppt

    hits = []
    next_hit = ppt.next_hit

    def watched(cfg, scene, params, pos, d, mask, shadow_ray=False, *a, **kw):
        out = next_hit(cfg, scene, params, pos, d, mask, shadow_ray, *a, **kw)
        hit = out if isinstance(out, ppt.Hit) else out[0]
        if not shadow_ray:
            hits.append(_hit_record(hit.closest, hit.normal, hit.mat_id,
                                    mask))
        return out

    ppt.next_hit = watched
    try:
        yield hits
    finally:
        ppt.next_hit = next_hit


def two_axis_lanes(hit):
    """The lanes of a dispatch's hits (``_hit_record``) on which the
    traversal returned a two-axis normal: two exits from a cell equal to
    the last bit."""
    return (hit["mask"] & np.isfinite(hit["closest"])
            & ((hit["normal"] != 0).sum(-1) > 1))


def sample_lanes(res):
    """(W, H): the lane of each pixel in one sample of a launch."""
    from voxelrt_torch.render import pipeline as ppipe

    w, h = res
    return ppipe._untile(w, h, torch.arange(w * h)).numpy()


def tie_pixels(hits, res):
    """(W, H) bool: the pixels with a sample on which any dispatch of
    ``hits`` (``port_hits``) returned a two-axis normal."""
    lanes = np.logical_or.reduce([two_axis_lanes(h) for h in hits])
    return lanes.reshape(-1, res[0] * res[1]).any(0)[sample_lanes(res)]


def example_gap(name, route="default", bar=1e-4):
    """Where the port's CPU render of ``name`` (one of ``EXAMPLES``) parts
    from ``render_example_jax``'s at ``GAP_RES``, on the JAX package's CPU
    default route or, with ``route='port'``, on ``PORT_ROUTE``: the image's
    RMSE, and for each pixel beyond ``bar`` the samples whose colours part
    beyond it and, along each such sample's path, the closest hits of both
    packages (distance, normal, material) up to the first that differs.
    Returns a dict."""
    import jax

    from voxelrt.render import pathtracer as jpt
    from voxelrt.render import pipeline as jpipe
    from voxelrt_torch.render import pipeline as ppipe

    w, h = res = GAP_RES
    n = w * h
    lane = sample_lanes(res)
    got = {"jax": dict(colour=[], hits=[]), "port": dict(colour=[])}

    def jax_hit(cfg, scene, params, pos, d, mask, shadow_ray, *a, **kw):
        out = jnext(cfg, scene, params, pos, d, mask, shadow_ray, *a, **kw)
        hit = out if isinstance(out, jpt.Hit) else out[0]
        if not shadow_ray:
            jax.debug.callback(
                lambda m, c, nx, ny, nz, mat: got["jax"]["hits"].append(
                    _hit_record(c, (nx, ny, nz), mat, m)),
                mask, hit.closest, *hit.normal, hit.mat_id, ordered=True)
        return out

    def jax_trace(*a, **kw):
        out = jtrace(*a, **kw)
        jax.debug.callback(lambda *c: got["jax"]["colour"].append(
            np.stack([np.asarray(x) for x in c], -1)), *out["diffuse"])
        return out

    def port_trace(*a, **kw):
        out = ptrace(*a, **kw)
        got["port"]["colour"].append(torch.stack(list(out["diffuse"]),
                                                 -1).numpy())
        return out

    jnext, jtrace, ptrace = jpt.next_hit, jpipe.trace_sample, \
        ppipe.trace_sample
    jpt.next_hit, jpipe.trace_sample = jax_hit, jax_trace
    ppipe.trace_sample = port_trace
    try:
        ref = render_example_jax(name, res,
                                 **(PORT_ROUTE if route == "port" else {}))
        with port_hits() as hits:
            img = render_example_port(name, res)
        got["port"]["hits"] = hits
    finally:
        jpt.next_hit, jpipe.trace_sample = jnext, jtrace
        ppipe.trace_sample = ptrace
    colour = {k: v["colour"][0] for k, v in got.items()}
    k = colour["port"].shape[0] // n
    diff = np.abs(img - ref).max(-1)
    pixels = []
    for u, v in zip(*np.nonzero(diff > bar)):
        samples = []
        for s in range(k):
            i = s * n + lane[u, v]
            if np.abs(colour["port"][i] - colour["jax"][i]).max() <= bar:
                continue
            path = []
            for depth, (a, b) in enumerate(zip(got["jax"]["hits"],
                                               got["port"]["hits"])):
                row = {side: dict(traced=bool(x["mask"][i]),
                                  closest=float(x["closest"][i]),
                                  normal=x["normal"][i].tolist(),
                                  mat=int(x["mat"][i]))
                       for side, x in (("jax", a), ("port", b))}
                path.append(dict(depth=depth, **row))
                if row["jax"] != row["port"] and (
                        row["jax"]["normal"] != row["port"]["normal"]
                        or row["jax"]["mat"] != row["port"]["mat"]
                        or abs(row["jax"]["closest"] - row["port"]["closest"])
                        > 1e-5 * abs(row["jax"]["closest"])):
                    break
            samples.append(dict(sample=s, jax=colour["jax"][i].tolist(),
                                port=colour["port"][i].tolist(), path=path))
        pixels.append(dict(u=int(u), v=int(v), diff=float(diff[u, v]),
                           samples=samples))
    # every lane on which the port's traversal returned a two-axis normal,
    # with the JAX package's hit there
    pixel_of = np.empty(n, np.int64)
    pixel_of[lane.ravel()] = np.arange(n)
    two_axis = []
    for depth, (a, b) in enumerate(zip(got["jax"]["hits"],
                                       got["port"]["hits"])):
        for i in np.nonzero(two_axis_lanes(b))[0]:
            u, v = divmod(int(pixel_of[i % n]), h)
            two_axis.append(dict(u=u, v=v, sample=int(i // n), depth=depth,
                                 port=b["normal"][i].tolist(),
                                 jax=a["normal"][i].tolist(),
                                 beyond=bool(diff[u, v] > bar)))
    return dict(name=name, res=list(res), route=route,
                rmse=float(np.sqrt(np.mean((img - ref) ** 2))),
                beyond=len(pixels), beyond_2_255=int((diff > 2 / 255).sum()),
                largest=float(diff.max()), two_axis=two_axis, pixels=pixels)


def regen(name, frames=None, out_dir=None, res=FULLRES_RES):
    """Render the golden ``name`` ('still', 'path' or 'restir') with the JAX
    package on the CPU at ``res`` and write it; print its seconds and the
    process's peak host memory. At a ``res`` other than 1280×720, a
    ``.json`` beside each image records the route, the resolution, the
    seconds and the peak host memory. For 'path', ``frames`` (counted from
    1) and ``out_dir`` keep other frames of the path, written as
    ``out_dir/fNN.png`` in place of the goldens."""
    import resource
    import time

    from voxelrt.utils.image import write_png

    res = tuple(res)
    t0 = time.perf_counter()
    if name == "still":
        out = {still_golden(res): render_example6_jax(res)}
        record = dict(example="example6", spp=FULLRES_SPL,
                      config=dict(samples_per_launch=FULLRES_SPL),
                      route=JAX_CPU_ROUTE)
    elif name == "path":
        imgs = render_example6_path_jax(res, keep=frames or PATH_KEEP)
        out = {(os.path.join(out_dir, f"f{n:02d}.png") if out_dir
                else path_golden(n, res)): img for n, img in imgs.items()}
        record = dict(example="example6", path=PATH_RECORD,
                      kept=sorted(imgs), config=PORT_ROUTE,
                      route="the JAX package's PORT_ROUTE (Pallas kernels "
                      "in interpret mode)")
    elif name == "restir":
        if res != FULLRES_RES:
            raise SystemExit("--res goes with still and path only")
        out = {RESTIR_GOLDEN: render_example6_restir_jax(res)}
        record = None
    else:
        raise SystemExit(f"unknown golden {name!r}: still, path or restir")
    seconds = time.perf_counter() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    for path, img in out.items():
        write_png(path, img)
        print(f"wrote {path}: {os.path.getsize(path)} bytes, mean "
              f"{img.mean():.4f}")
        if record is not None and res != FULLRES_RES and not out_dir:
            _write_json(path[:-len(".png")] + ".json", dict(
                record, res=list(res), seed=0, seconds=seconds,
                peak_host_gib=peak_gb, bytes=os.path.getsize(path)))
    print(f"{name}: render {seconds:.1f} s, peak host memory "
          f"{peak_gb:.2f} GiB")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Remake a full-width golden with the JAX package.")
    ap.add_argument("--regen", nargs="?", const="still", default=None,
                    choices=("still", "path", "restir", "sky", "examples"))
    ap.add_argument("--gap", default=None, metavar="NAME",
                    help="in place of --regen: where the port's CPU render "
                    "of the example NAME parts from the JAX package's "
                    "(example_gap), one JSON line a pixel beyond 1e-4")
    ap.add_argument("--route", default="default", choices=("default", "port"),
                    help="'--gap' only: the JAX package's CPU default route "
                    "or PORT_ROUTE")
    ap.add_argument("names", nargs="*",
                    help="'examples': the scenes (default: "
                    f"{' '.join(EXAMPLES + (RESTIR_EXAMPLE,))}); 'sky': the "
                    "one example whose sky to make (default example6)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="'examples' only: scenes made side by side "
                    "(about 12 GB of host memory each)")
    ap.add_argument("--frames", default=None,
                    help="'path' only: frames to keep, e.g. 1,2,24")
    ap.add_argument("--out", default=None,
                    help="'path' only: write the kept frames here as fNN.png")
    ap.add_argument("--sky-res", default=None,
                    help="'sky' only: the skybox_res of each golden, made "
                    f"in this order (default: {','.join(map(str, SKY_RES))} "
                    "for example6, 128 for another example)")
    ap.add_argument("--res", default=None, metavar="WxH",
                    help="'still' and 'path' only: the image size (default "
                    f"{FULLRES_RES[0]}x{FULLRES_RES[1]}; "
                    f"{REF_RES[0]}x{REF_RES[1]} is the reference's own)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.gap:
        gap = example_gap(args.gap, args.route)
        for p in gap.pop("pixels"):
            print(json.dumps(p))
        print(json.dumps(gap))
        sys.exit(0)
    if args.regen is None:
        ap.error("--regen or --gap")
    if (args.frames is None) != (args.out is None):
        ap.error("--frames and --out go together")
    if args.regen == "sky":
        (name,) = args.names or ["example6"]
        sizes = (args.sky_res or (",".join(map(str, SKY_RES))
                                  if name == "example6" else "128"))
        regen_sky(tuple(int(r) for r in sizes.split(",")), name)
        sys.exit(0)
    if args.regen == "examples":
        known = EXAMPLES + (RESTIR_EXAMPLE,)
        if set(args.names) - set(known):
            ap.error(f"unknown scenes {sorted(set(args.names) - set(known))}")
        regen_examples(tuple(args.names) or known, args.jobs)
        sys.exit(0)
    if args.names:
        ap.error("scene names go with --regen examples and sky only")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    regen(args.regen,
          frames=tuple(int(n) for n in args.frames.split(","))
          if args.frames else None, out_dir=args.out,
          res=tuple(int(x) for x in args.res.split("x")) if args.res
          else FULLRES_RES)
