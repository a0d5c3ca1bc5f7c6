"""PyTorch port, the sky precompute at the JAX package's default knobs:
example6's sky as the JAX package computes it on the CPU
(``tests/golden/torch_fullres/example6_sky_{128,16}.npz``, made by
``python tests/test_torch_golden.py --regen sky``: the unedited
``voxelrt.sky.atmos.prepare_sky`` with every knob of example6's
``RenderConfig`` at its default but ``skybox_res``), read here from disk.

* Each golden is the JAX package's ``sky_<key>.npz`` as it wrote it: maps of
  the shape its ``skybox_res`` gives, finite, keyed as the port keys the
  same config and light.
* The port's ``prepare_sky`` on the CPU at 16² and the default depth (32
  accumulation passes of 32-step cloud marches, 64-step sky marches with 8
  sun samples and 8×5 multi-scatter) meets the 16² golden at the bars of
  tests/test_torch_sky.py::test_prepare_sky_matches_jax, unchanged: 95% of
  texels within rtol 2e-4 / atol 1e-7, relative RMSE under 6e-2
  (scattering) and 1.5e-2 (transmittance), the cloud ambient within 1e-6
  and the LUT within 2e-6. ``chip_smoke.py`` phase 32 holds the card's sky
  to the 128² golden at the same bars, with the same comparison
  (``chip_smoke.sky_agreement``), which this test also runs.
* The port's ``load_sky`` reads the 128² golden bit for bit.
* The fault these goldens showed: the JAX package's chunk functions capture
  the camera as a constant, so XLA folds ``-|pos|^2 + r*r`` of its
  ray-sphere intersections into one constant and fuses ``b*b + k``; the
  port formed ``b*b - |pos|^2`` and added ``r*r`` after, one rounding more.
  A distance from the ground is ``-b +- sq`` with both near 2e6 m, whose
  float32 step is a quarter metre, so that rounding moved about half the
  camera's intersections, up to 9 m at 64², and every cloud march step
  with them: over 32 passes of 32 steps, 20% of the 16² golden's texels
  missed (0.8008 of them within tolerance). The port's ``rsi`` now folds a
  constant origin as XLA does, bit for bit; with it and the texel
  directions' sine, cosine and reciprocal square root correctly rounded the
  share is 0.9766, and 1.0 with the JAX package's own directions."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sky as tsky
from test_torch_golden import (SKY_GOLDENS, SKY_KNOBS, SKY_RES, sky_args,
                               sky_record)

import chip_smoke
from voxelrt.config import RenderConfig as JCfg
from voxelrt.sky import atmos as jatmos
from voxelrt_torch.app.examples import build_example
from voxelrt_torch.config import RenderConfig
from voxelrt_torch.ops.texfetch import pack_rgb_bf16
from voxelrt_torch.ops.v3 import V3, splat
from voxelrt_torch.sky import atmos

# One thread per test process: the suite runs several processes side by
# side.
torch.set_num_threads(1)


def _example6(res):
    """The port's example6 on the CPU with ``skybox_res`` = ``res``: its
    config and the light prepare_data gives prepare_sky."""
    scene = build_example("example6", "cpu", (64, 36), skybox_res=res)
    return scene.renderer.cfg, sky_args(scene)


@pytest.mark.parametrize("res", SKY_RES)
def test_sky_golden_is_the_jax_file_at_default_knobs(res):
    rec = sky_record(res)
    cfg, args = _example6(res)
    defaults = RenderConfig()
    assert rec["skybox_res"] == res
    assert rec["knobs"] == {k: getattr(cfg, k) for k in SKY_KNOBS}
    # every knob but skybox_res at its default, clouds on
    assert {k: v for k, v in rec["knobs"].items()
            if k not in ("skybox_res", "use_clouds")} == {
        k: getattr(defaults, k) for k in SKY_KNOBS
        if k not in ("skybox_res", "use_clouds")}
    assert rec["knobs"]["use_clouds"] is True
    np.testing.assert_array_equal(np.float32(rec["sun_dir"]), args[0])
    np.testing.assert_array_equal(np.float32(rec["sun_col"]), args[1])
    assert np.float32(rec["cos_max"]) == np.float32(args[2])
    assert rec["key"] == atmos._cache_key(cfg, *args)
    with np.load(SKY_GOLDENS[res]) as z:
        assert sorted(z.files) == ["ambient", "lut", "scatt", "trans"]
        assert z["scatt"].shape == z["trans"].shape == (res, res, 3)
        assert z["ambient"].shape == (3,)
        assert z["lut"].shape == tuple(cfg.trans_lut_res) + (3,)
        for name in z.files:
            assert z[name].dtype == np.float32
            assert np.isfinite(z[name]).all()
        # a lit sky with clouds, not a constant
        assert z["scatt"].std() > 1e-3 and z["trans"].std() > 1e-2


def test_prepare_sky_default_knobs_matches_jax_golden(tmp_path):
    res = 16
    cfg, args = _example6(res)
    stats = {}
    sky = atmos.prepare_sky(cfg, *args, quiet=True, cache_dir=str(tmp_path),
                            stats=stats, device="cpu")
    assert not stats["cache_hit"]
    assert os.listdir(tmp_path) == [f"sky_{sky_record(res)['key']}.npz"]
    with np.load(SKY_GOLDENS[res]) as z:
        golden = atmos.SkyData(z["scatt"], z["trans"], z["ambient"], z["lut"])
    assert sky.skybox_scattering.shape == (res, res, 3)
    assert np.isfinite(sky.skybox_scattering).all()
    assert np.isfinite(sky.skybox_transmittance).all()
    tsky._close(sky.cloud_ambient, golden.cloud_ambient, atol=1e-6)
    tsky._close(sky.trans_lut, golden.trans_lut, atol=2e-6)
    share = tsky._texel_share(sky, golden)
    rs = tsky._rel_rmse(sky.skybox_scattering, golden.skybox_scattering)
    rt = tsky._rel_rmse(sky.skybox_transmittance, golden.skybox_transmittance)
    # phase 32's comparison gives the same numbers, and splits the misses
    agree = chip_smoke.sky_agreement(cfg, args, sky, golden, "cpu")
    print(f"prepare_sky {res}^2 at the default knobs on the CPU against the "
          f"JAX package's: {share:.4f} of texels within rtol {tsky.RTOL} / "
          f"atol {tsky.ATOL}; relative RMSE scattering {rs:.3e}, "
          f"transmittance {rt:.3e}; the texels that miss by layer "
          f"{agree['layers']}; {stats['cloud_s']:.1f} s in the cloud stage, "
          f"{stats['sky_s']:.1f} s in the sky stage")
    assert agree["share"] == share
    assert agree["rel_rmse_scattering"] == rs
    assert agree["rel_rmse_transmittance"] == rt
    assert agree["ambient_ok"] and agree["lut_ok"]
    assert sum(v["texels"] for v in agree["layers"].values()) == res * res
    assert share >= 0.95, share
    assert rs < 6e-2 and rt < 1.5e-2, (rs, rt)


def test_load_sky_reads_the_jax_golden_bit_for_bit(tmp_path):
    res = 128
    cfg, args = _example6(res)
    key = sky_record(res)["key"]
    shutil.copyfile(SKY_GOLDENS[res], tmp_path / f"sky_{key}.npz")
    stats = {}
    sky = atmos.prepare_sky(cfg, *args, quiet=True, cache_dir=str(tmp_path),
                            stats=stats, device="cpu")
    assert stats["cache_hit"]
    loaded = atmos.load_sky(cfg, *args, "cpu", str(tmp_path))
    with np.load(SKY_GOLDENS[res]) as z:
        for got in (sky, loaded):
            for field, name in (("skybox_scattering", "scatt"),
                                ("skybox_transmittance", "trans"),
                                ("cloud_ambient", "ambient"),
                                ("trans_lut", "lut")):
                want = z[name]
                have = getattr(got, field)
                assert have.dtype == np.float32 and have.shape == want.shape
                np.testing.assert_array_equal(have.view(np.uint32),
                                              want.view(np.uint32))
            np.testing.assert_array_equal(
                got.packed_scatt.numpy(),
                pack_rgb_bf16(z["scatt"]).view(np.int32))
            np.testing.assert_array_equal(
                got.packed_trans.numpy(),
                pack_rgb_bf16(z["trans"]).view(np.int32))
    # another config's key finds nothing in that directory
    assert atmos.load_sky(dataclasses.replace(cfg, cloud_accum_passes=16),
                          *args, "cpu", str(tmp_path)) is None


def test_rsi_from_the_camera_matches_xla_bit_for_bit():
    """Ray-sphere intersections from the camera, which the JAX package's
    chunk functions capture as a constant, at the four radii the sky uses,
    on every texel direction of a 64² sky: near and far bit-equal to the
    JAX package's jitted ``rsi``. Each radius's share of equal distances
    and largest difference in metres are printed before the check."""
    res = 64
    n = res * res
    dirs = np.asarray(jax.jit(
        lambda: jatmos._texel_dirs(JCfg(skybox_res=res), 0, n))())
    cam = jnp.broadcast_to(jnp.asarray(jatmos.CAM_POS), (n, 3))
    tdirs = V3(*(torch.from_numpy(dirs[:, i].copy()) for i in range(3)))
    tcam = splat(atmos._f32(atmos.CAM_POS, "cpu"))
    pairs = []
    for r in (atmos.PLANET_R, atmos.PLANET_R + atmos.CLOUD_HEIGHT,
              atmos.PLANET_R + atmos.CLOUD_HEIGHT + atmos.CLOUD_THICKNESS,
              atmos.PLANET_R + atmos.ATMOS_HEIGHT):
        want = [np.asarray(x) for x in jax.jit(
            lambda d, r=r: jatmos.rsi(cam, d, r))(jnp.asarray(dirs))]
        got = [x.numpy() for x in atmos.rsi(tcam, tdirs, r)]
        for name, w, g in zip(("near", "far"), want, got):
            print(f"rsi from the camera, radius {r:.0f} m, {name}: "
                  f"{(g == w).mean():.4f} equal, largest difference "
                  f"{np.abs(g.astype(np.float64) - w).max():.4f} m")
            pairs.append((g, w))
    for g, w in pairs:
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_default_knobs_gap_is_the_texel_directions(tmp_path, monkeypatch):
    """With the JAX package's own texel directions (jitted, as its chunk
    functions compute them) in place of the port's, the port's CPU sky at
    16² and the default depth meets the 16² golden on every texel: what
    separates the two at the default knobs is the directions alone, whose
    last bits no port matches everywhere (the host's approximate rsqrt,
    tests/test_torch_sky.py::test_texel_dirs_ulp_distance). Measured: every
    texel, relative RMSE 1.3e-6 (scattering) and 2.2e-7 (transmittance);
    the bars lie above that."""
    res = 16
    n = res * res
    cfg, args = _example6(res)
    jd = np.asarray(jax.jit(
        lambda: jatmos._texel_dirs(JCfg(skybox_res=res), 0, n))())
    port = np.stack([c.numpy() for c in atmos._texel_dirs(cfg, 0, n, "cpu")],
                    -1)

    def jax_dirs(cfg_, chunk_idx, chunk, device):
        shape = tuple(torch.as_tensor(chunk_idx).shape) + (chunk,)
        return V3(*(torch.from_numpy(jd[:, i].copy()).reshape(shape)
                    for i in range(3)))

    monkeypatch.setattr(atmos, "_texel_dirs", jax_dirs)
    sky = atmos.prepare_sky(cfg, *args, quiet=True, cache_dir=str(tmp_path),
                            device="cpu")
    with np.load(SKY_GOLDENS[res]) as z:
        golden = atmos.SkyData(z["scatt"], z["trans"], z["ambient"], z["lut"])
    share = tsky._texel_share(sky, golden)
    rs = tsky._rel_rmse(sky.skybox_scattering, golden.skybox_scattering)
    rt = tsky._rel_rmse(sky.skybox_transmittance, golden.skybox_transmittance)
    print(f"the port's sky at {res}^2 on the JAX package's directions "
          f"({(port == jd).all(-1).mean():.4f} of them bit-equal to the "
          f"port's own): {share:.4f} of texels within tolerance, relative "
          f"RMSE {rs:.2e}, {rt:.2e}")
    assert share >= 0.99, share
    assert rs < 1e-5 and rt < 1e-5, (rs, rt)
