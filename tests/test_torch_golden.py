"""PyTorch port: the golden images of tests/test_golden.py, rendered by the
port, and the full-width golden that ``chip_smoke.py`` holds the card to.

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

      python tests/test_torch_golden.py --regen
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, "golden")
FULLRES = os.path.join(GOLDEN_DIR, "torch_fullres",
                       "example6_1280x720_16spp.png")
FULLRES_RES = (1280, 720)
FULLRES_SPL = 16
RES = (96, 54)
SPP = 24


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


def render_example6_jax(res):
    """example6 through the JAX package's ``Scene`` on the CPU at ``res``,
    16 samples in one launch, as the module's docstring says. The render
    runs in an empty working directory, so the sky can come only from
    ``data/skycache/``: a recomputed sky would be written to that
    directory's ``.skycache/``, and that fails."""
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    for d in (ROOT, os.path.join(ROOT, "examples")):
        if d not in sys.path:
            sys.path.insert(0, d)
    sys.modules.pop("example6", None)
    import example6

    example6.initialize_voxels()
    scene = example6.scene
    scene.config = dataclasses.replace(scene.config, image_res=tuple(res),
                                       samples_per_launch=FULLRES_SPL)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            img = scene.finish(spp=FULLRES_SPL, save=False)
        finally:
            os.chdir(cwd)
        if os.path.exists(os.path.join(tmp, ".skycache")):
            raise RuntimeError("the sky was recomputed, not loaded from "
                               "data/skycache/")
    sys.modules.pop("example6", None)
    return np.asarray(img)


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


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import time

        sys.path.insert(0, ROOT)
        from voxelrt.utils.image import write_png

        t0 = time.perf_counter()
        img = render_example6_jax(FULLRES_RES)
        seconds = time.perf_counter() - t0
        write_png(FULLRES, img)
        print(f"wrote {FULLRES}: {os.path.getsize(FULLRES)} bytes, render "
              f"{seconds:.1f} s, mean {img.mean():.4f}")
