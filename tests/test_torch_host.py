"""PyTorch port, host side: config, world, camera, materials, acceleration
tables, sky cache key, interop, import hygiene and the no-CPU-fallback rule.

The port (voxelrt_torch) is held against the JAX package (voxelrt) on the
same inputs; host-side tables must be bitwise equal."""

import ast
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt import config as jcfg
from voxelrt import materials as jmat
from voxelrt.app import testing
from voxelrt.ops import accel as jaccel
from voxelrt.render import pathtracer as jpt
from voxelrt.sky import atmos as jatmos

import voxelrt_torch
from voxelrt_torch import config as tcfg
from voxelrt_torch import materials as tmat
from voxelrt_torch.ops import accel as taccel
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.sky import atmos as tatmos

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example6_world():
    """example6's voxel world, built through the port's Scene (CPU) with
    examples/ untouched: the shared make_scene is swapped before import."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import _common

    from voxelrt_torch.scene import Scene

    saved = _common.make_scene
    _common.make_scene = lambda argv=None, **kw: Scene(quiet=True,
                                                      device="cpu", **kw)
    try:
        sys.modules.pop("example6", None)
        import example6

        example6.initialize_voxels()
        return example6.scene
    finally:
        _common.make_scene = saved
        sys.modules.pop("example6", None)


def test_config_defaults_match():
    a, b = jcfg.RenderConfig(), tcfg.RenderConfig()
    assert [f.name for f in dataclasses.fields(a)] == [
        f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    for p in ("n_lods", "aspect_ratio", "voxel_inv_dx", "grid_offset"):
        assert getattr(a, p) == getattr(b, p)


@pytest.mark.parametrize("unroll", ["auto", 1, 2, 5, "bogus", 2.0])
def test_march_unroll_resolution_matches(unroll):
    a = jcfg.RenderConfig(dda_march_unroll=unroll)
    b = tcfg.RenderConfig(dda_march_unroll=unroll)
    assert jpt.march_unroll_of(a) == tpt.march_unroll_of(b)


def test_world_and_camera_match():
    from voxelrt import camera as jcam, world as jworld
    from voxelrt_torch import camera as tcam, world as tworld

    cfg = testing.tiny_config()
    jw = testing.make_test_world(cfg, seed=3)
    tw = tworld.VoxelWorld(cfg.voxel_dx, cfg.grid_res, cfg.voxel_edges)
    tw.material, tw.color = jw.material.copy(), jw.color.copy()
    ja, ta = jw.device_arrays(), tw.device_arrays()
    np.testing.assert_array_equal(np.asarray(ja["occ_words"]), ta["occ_words"])
    np.testing.assert_array_equal(ja["voxels_np"], ta["voxels"])
    np.testing.assert_array_equal(
        jworld.build_occupancy_pyramid(jw.material != 0, 5),
        tworld.build_occupancy_pyramid(tw.material != 0, 5))
    idx = np.random.default_rng(0).integers(-20, 20, (64, 3))
    for a, b in zip(jw.get_voxels(idx), tw.get_voxels(idx)):
        np.testing.assert_array_equal(a, b)
    jc, tc = jcam.Camera(), tcam.Camera()
    for c in (jc, tc):
        c.set_pose((0.3, 0.7, 1.9), (0.1, 0.0, -0.2))
        c.orbit(0.01, -0.02)
        c.translate("wd", 0.5)
    for a, b in zip(jc.matrices(0.8, 16 / 9), tc.matrices(0.8, 16 / 9)):
        np.testing.assert_array_equal(a, b)


def test_materials_match():
    jm, tm = jmat.MaterialList(), tmat.MaterialList()
    np.testing.assert_array_equal(jm.params_np, tm.params_np)
    csv = "id,r,g,b,ss,m,s,st,r,a,sh,sht,cc,ccg,ior\n" + \
        "12,0.5,0.4,0.3,0,0.2,0.5,0,0.3,0.1,0,0,0.4,0.6,0.5\n"
    np.testing.assert_array_equal(jmat.MaterialList.from_csv(csv).params_np,
                                  tmat.MaterialList.from_csv(csv).params_np)
    ids = np.random.default_rng(1).choice([0, 1, 2, 11, 52, 80, 131], 500)
    ja = jmat.fetch_material(jm.params, jnp.asarray(ids))
    ta = tmat.fetch_material(tm.params("cpu"), torch.as_tensor(ids))
    np.testing.assert_array_equal(np.asarray(ja.base_col),
                                  ta.base_col.numpy())
    for f in jmat.Material._fields[1:]:
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f).numpy(), err_msg=f)


def _tables_equal(material, voxels, res, light, cone_cos):
    jt = jaccel.build_pallas_tables(material, voxels, res)
    tt = taccel.build_pallas_tables(material, voxels, res)
    jt = jaccel.add_sun_open_table(jt, material, light, cone_cos)
    tt = taccel.add_sun_open_table(tt, material, light, cone_cos)
    for f in jaccel.PallasTables._fields[:-1]:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f)
        assert a.dtype == b.dtype == np.uint32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jt.grid_res == tt.grid_res
    return tt


def test_tables_bitwise_test_world():
    cfg = testing.production_test_config()
    w = testing.make_test_world(cfg)
    ld = np.asarray(testing.TEST_LIGHT_DIR) / np.linalg.norm(
        testing.TEST_LIGHT_DIR)
    tt = _tables_equal(w.material, w.device_arrays()["voxels_np"],
                       cfg.grid_res, ld, testing.TEST_CONE_COS)
    assert tt.palette_words.size == 1024  # palette mode


def test_tables_bitwise_example6():
    scene = _example6_world()
    w = scene.world
    assert w.grid_res == 128 and (w.material != 0).sum() > 100_000
    _tables_equal(w.material, w.device_arrays()["voxels"], 128,
                  np.asarray(scene._light_direction, np.float64),
                  float(scene._light_cone_cos_theta_max))


def test_sky_cache_key_matches_and_loads_shipped_example6():
    cfg = jcfg.RenderConfig(use_physical_sky=True, use_clouds=True)
    light = np.array([1.0, 1.0, -1.0]) / math.sqrt(3.0)
    col = np.array([1.3, 0.949 * 1.3, 0.937 * 1.3], np.float32) * 3.0
    cos = math.cos(0.025 * 0.5)
    key = jatmos._cache_key(cfg, light.astype(np.float32), col, cos)
    assert key == tatmos._cache_key(tcfg.RenderConfig(
        use_physical_sky=True, use_clouds=True), light.astype(np.float32),
        col, cos) == "22bb6a2969bf92c0"
    sky = tatmos.load_sky(cfg, light.astype(np.float32), col, cos, "cpu",
                          cache_dir=os.path.join(ROOT, "no-such-dir"))
    assert sky.packed_scatt.shape == (2 * 1024 * 1024,)
    # a sky that no cache holds: the lookup half says so, and prepare_sky
    # then computes it (tests/test_torch_sky.py)
    assert tatmos.load_sky(cfg, light.astype(np.float32), col * 2, cos, "cpu",
                           cache_dir=os.path.join(ROOT, "no-such-dir")) is None


def test_interop_from_jax_arrays():
    from voxelrt_torch import interop

    cfg = testing.tiny_config(use_pallas_dda=True)
    sd = testing.make_scene_data(cfg)
    p = testing.make_params(cfg)
    tables = {k: (v if isinstance(v, int) else np.asarray(v))
              for k, v in sd.tables._asdict().items()}
    tsd, tp = interop.from_jax_arrays(
        dict(occ_words=np.asarray(sd.occ_words), voxels=np.asarray(sd.voxels),
             mat_params=np.asarray(sd.mat_params), tables=tables, sky=None),
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    np.testing.assert_array_equal(
        tsd.tables.cell_colors.numpy().view(np.uint32),
        np.asarray(sd.tables.cell_colors))
    np.testing.assert_array_equal(tsd.voxels.numpy().view(np.uint32),
                                  np.asarray(sd.voxels))
    assert tp.floor_material.dtype == torch.int32
    np.testing.assert_array_equal(tp.proj_inv.numpy(), np.asarray(p.proj_inv))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_voxelrt():
    pkg = os.path.join(ROOT, "voxelrt_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [
        os.path.join(ROOT, "chip_smoke.py"),
        os.path.join(ROOT, "tools", "camera_path_bench_torch.py"),
        os.path.join(ROOT, "tools", "restir_quality_torch.py")]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "voxelrt"), (path, mod)


def test_no_cpu_fallback():
    """Entry points with no device resolve to the CUDA card and raise when
    there is none; they never move to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    from voxelrt_torch.app.headless import HeadlessRenderer
    from voxelrt_torch.scene import Scene

    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(quiet=True).finish(spp=1, save=False)
    cpu_scene = Scene(quiet=True, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        HeadlessRenderer(cpu_scene.config, cpu_scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelrt_torch.resolve_device(None)
    assert voxelrt_torch.resolve_device("cpu").type == "cpu"
