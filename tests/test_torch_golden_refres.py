"""PyTorch port: the goldens that ``chip_smoke.py`` phases 34 and 16 hold the
card to, read here from disk.

* ``tests/golden/torch_fullres/example6_1920x1080_16spp.png``: example6 at
  the reference's own resolution (its ``scene.py`` default, 1920×1080),
  rendered by the JAX package on the CPU as ``example6_1280x720_16spp.png``
  is: one launch of 16 samples from the ``Scene``'s default seed on its CPU
  default route, the sky from ``data/skycache/``.
* ``example6_path_1080p_f24.png`` and ``..._f30.png``: frames 24 (the last
  moving one, 960×540 active, upsampled) and 30 (the last still one) of
  the camera path of ``example6_path_f24/f30.png``, at 1920×1080, on the
  port's route (the JAX package's Pallas kernels in interpret mode).
* ``example7_sky_128.npz``: example7's low-sun sky (its own light, direction
  (−0.7, 0.25, −1), with its night settings) computed by the JAX package's
  unedited ``prepare_sky`` on the CPU at ``skybox_res=128`` and every other
  knob of its ``RenderConfig`` at its default, as ``example6_sky_128.npz``
  is for example6.

Each has a ``.json`` beside it (the route or the knobs, the seconds, the
peak host memory). Remake them with:

    python tests/test_torch_golden.py --regen still --res 1920x1080
    python tests/test_torch_golden.py --regen path --res 1920x1080
    python tests/test_torch_golden.py --regen sky example7

The moving frames at 1920×1080 trace a 960×540 grid, which does not tile
(540 % 8 = 4): their lanes take the column-order route
(``pipeline._pixel_uv_from_index`` and ``_untile`` without tiles). On the
CPU that route is held to the JAX package by
tests/test_torch_golden_paths.py::test_path_generator_matches_port, whose
128×72 camera path moves at 64×36, which does not tile either."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import test_torch_golden as tg
from test_torch_golden import SKY_KNOBS, sky_args
from test_torch_golden_paths import SMALL

import chip_smoke
from voxelrt_torch.app.examples import build_example
from voxelrt_torch.config import RenderConfig
from voxelrt_torch.render import pipeline
from voxelrt_torch.sky import atmos

torch.set_num_threads(1)

REF = tg.REF_RES
REF_GOLDENS = {"still": tg.still_golden(REF),
               **{f"f{n}": tg.path_golden(n, REF) for n in tg.PATH_KEEP}}
SKY7 = tg.sky_golden(128, "example7")


def _record(path):
    with open(os.path.splitext(path)[0] + ".json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", sorted(REF_GOLDENS))
def test_ref_res_golden_reads_as_an_image(name):
    """A 1080-row, 1920-column RGB PNG, read as the (W, H, 3) image the
    port's ``Scene.finish`` returns: a lit frame, not a constant; its
    record names the resolution, the route and what the render cost."""
    from voxelrt_torch.utils.image import read_png

    path = REF_GOLDENS[name]
    with open(path, "rb") as fh:
        head = fh.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == REF
    img = read_png(path)
    assert img.shape == REF + (3,) and img.dtype == np.float32
    assert 0.05 < img.mean() < 0.95 and img.std() > 0.05
    rec = _record(path)
    assert rec["res"] == list(REF) and rec["example"] == "example6"
    assert rec["seed"] == 0 and rec["bytes"] == os.path.getsize(path)
    assert rec["seconds"] > 0 and rec["peak_host_gib"] > 0
    if name == "still":
        assert rec["spp"] == tg.FULLRES_SPL
        assert rec["config"] == dict(samples_per_launch=tg.FULLRES_SPL)
        assert rec["route"] == tg.JAX_CPU_ROUTE
    else:
        assert rec["config"] == tg.PORT_ROUTE
        assert rec["kept"] == list(tg.PATH_KEEP)
        path = rec["path"]
        assert path == json.loads(json.dumps(tg.PATH_RECORD))
        assert ([tg.MOVE] * path["moving"] + [tg.HOLD] * path["still"]
                == tg.PATH_FRAMES)


def test_chip_smoke_reads_these_goldens():
    """Phases 34 and 16 name the files made here, at the same resolution,
    sample count and camera path."""
    def rel(p):
        return os.path.relpath(p, tg.ROOT)

    assert chip_smoke.REF_RES == REF
    assert chip_smoke.REF_GOLDEN == rel(REF_GOLDENS["still"])
    assert {n: chip_smoke.REF_PATH_GOLDENS[n] for n in tg.PATH_KEEP} == {
        n: rel(REF_GOLDENS[f"f{n}"]) for n in tg.PATH_KEEP}
    assert chip_smoke.FULLRES_SPL == tg.FULLRES_SPL
    assert (chip_smoke.N_MOVING, chip_smoke.N_STILL) == (24, 6)
    assert [chip_smoke.MOVE] * 24 + [chip_smoke.HOLD] * 6 == tg.PATH_FRAMES
    assert chip_smoke.SKY7_GOLDEN == rel(SKY7)


@pytest.mark.parametrize("res", [REF, SMALL])
def test_moving_frames_take_the_column_order_route(res):
    """At 1920×1080 and at tests/test_torch_golden_paths.py's 128×72 the
    moving frame's active grid (render scale 0.5) does not tile and the
    still one does; the column order lists every pixel of the moving grid
    once a sample."""
    cfg = RenderConfig(image_res=res)
    aw, ah = pipeline.active_res(cfg, 0.5)
    assert (aw, ah) == (res[0] // 2, res[1] // 2) and ah % pipeline.TILE_H
    assert not pipeline.block_tiled(aw, ah, aw)
    assert pipeline.block_tiled(*res, res[0])
    u, v, s = pipeline.wavefront_constants(
        RenderConfig(image_res=res, samples_per_launch=2), 0.5, "cpu")
    n = aw * ah
    assert s.tolist() == [0] * n + [1] * n
    for k in range(2):
        pix = (u[k * n:(k + 1) * n] * ah + v[k * n:(k + 1) * n]).long()
        assert torch.equal(torch.sort(pix).values, torch.arange(n))
    # the lanes come back as the (aw, ah) image they were traced for
    img = pipeline._untile(aw, ah, torch.stack([u[:n], v[:n]], -1))
    assert torch.equal(img[..., 0], torch.arange(aw, dtype=torch.float32)
                       [:, None].expand(aw, ah))
    assert torch.equal(img[..., 1], torch.arange(ah, dtype=torch.float32)
                       [None, :].expand(aw, ah))


@pytest.fixture(scope="module")
def example7():
    """The port's example7 on the CPU at ``skybox_res=128``: its config
    and the light prepare_data gives prepare_sky."""
    scene = build_example("example7", "cpu", (16, 9), skybox_res=128)
    return scene.renderer.cfg, sky_args(scene)


def test_example7_sky_golden_is_the_jax_file_at_default_knobs(example7):
    """The JAX package's ``sky_<key>.npz`` of example7 at 128² as it wrote
    it, every knob but ``skybox_res`` at its default, keyed as the port
    keys the same config and example7's own light."""
    rec = _record(SKY7)
    cfg, args = example7
    defaults = RenderConfig()
    assert rec["example"] == "example7" and rec["skybox_res"] == 128
    assert rec["knobs"] == {k: getattr(cfg, k) for k in SKY_KNOBS}
    assert {k: v for k, v in rec["knobs"].items()
            if k not in ("skybox_res", "use_clouds")} == {
        k: getattr(defaults, k) for k in SKY_KNOBS
        if k not in ("skybox_res", "use_clouds")}
    assert rec["knobs"]["use_clouds"] is True
    np.testing.assert_array_equal(np.float32(rec["sun_dir"]), args[0])
    np.testing.assert_array_equal(np.float32(rec["sun_col"]), args[1])
    assert np.float32(rec["cos_max"]) == np.float32(args[2])
    # the low sun: example7's (-0.7, 0.25, -1), normalised
    d = np.array([-0.7, 0.25, -1.0])
    np.testing.assert_allclose(rec["sun_dir"], d / np.linalg.norm(d),
                               rtol=1e-6)
    assert rec["key"] == atmos._cache_key(cfg, *args)
    assert rec["seconds"] > 0 and rec["peak_host_gib"] > 0
    with np.load(SKY7) as z:
        assert sorted(z.files) == ["ambient", "lut", "scatt", "trans"]
        assert z["scatt"].shape == z["trans"].shape == (128, 128, 3)
        assert z["ambient"].shape == (3,)
        assert z["lut"].shape == tuple(cfg.trans_lut_res) + (3,)
        for name in z.files:
            assert z[name].dtype == np.float32
            assert np.isfinite(z[name]).all()
        assert z["scatt"].std() > 1e-4 and z["trans"].std() > 1e-2


def test_load_sky_reads_the_example7_golden_bit_for_bit(tmp_path, example7):
    cfg, args = example7
    key = _record(SKY7)["key"]
    shutil.copyfile(SKY7, tmp_path / f"sky_{key}.npz")
    stats = {}
    sky = atmos.prepare_sky(cfg, *args, quiet=True, cache_dir=str(tmp_path),
                            stats=stats, device="cpu")
    assert stats["cache_hit"]
    with np.load(SKY7) as z:
        for field, name in (("skybox_scattering", "scatt"),
                            ("skybox_transmittance", "trans"),
                            ("cloud_ambient", "ambient"),
                            ("trans_lut", "lut")):
            np.testing.assert_array_equal(getattr(sky, field), z[name])
