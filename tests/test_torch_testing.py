"""PyTorch port: ``voxelrt_torch.app.testing`` (configs, the test world,
scene data and params built without JAX) against the JAX package's
``voxelrt.app.testing`` taken through ``voxelrt_torch.interop``: every table
and parameter tensor bit for bit. The sky goes through ``prepare_sky``'s
cache, whose files both packages read and write under one key, so it is
bit for bit as well."""

import dataclasses

import numpy as np
import pytest
import torch

from voxelrt.app import testing as jtesting

from voxelrt_torch import interop
from voxelrt_torch.app import testing

torch.set_num_threads(1)


def _np(nt):
    return {k: (v if isinstance(v, int) else np.asarray(v))
            for k, v in nt._asdict().items()}


@pytest.mark.parametrize("make", ["tiny_config", "production_test_config"])
def test_configs_match(make):
    a = getattr(jtesting, make)(image_res=(48, 24))
    b = getattr(testing, make)(image_res=(48, 24))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_test_world_matches():
    cfg = testing.tiny_config()
    a, b = jtesting.make_test_world(cfg, seed=5), testing.make_test_world(
        cfg, seed=5)
    assert np.array_equal(a.material, b.material)
    assert np.array_equal(a.color, b.color)


def _equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("make", ["tiny_config", "production_test_config"])
def test_scene_data_and_params_bitwise(make):
    cfg = getattr(testing, make)()
    jcfg = getattr(jtesting, make)()
    jsd = jtesting.make_scene_data(jcfg)
    jp = jtesting.make_params(jcfg)
    tsd = testing.make_scene_data(cfg, "cpu")
    tp = testing.make_params(cfg, "cpu")
    if jsd.tables is not None:
        jt = _np(jsd.tables)
    else:
        # the JAX package builds its kernel tables only under use_pallas_dda;
        # the port always does
        from voxelrt.ops.accel import add_sun_open_table, build_pallas_tables

        w = jtesting.make_test_world(jcfg)
        ld = np.asarray(jtesting.TEST_LIGHT_DIR, np.float64)
        jt = _np(add_sun_open_table(
            build_pallas_tables(w.material, w.device_arrays()["voxels_np"],
                                jcfg.grid_res),
            w.material, ld / np.linalg.norm(ld), jtesting.TEST_CONE_COS))
    want_sd, want_p = interop.from_jax_arrays(
        dict(occ_words=np.asarray(jsd.occ_words),
             voxels=np.asarray(jsd.voxels),
             mat_params=np.asarray(jsd.mat_params), tables=jt,
             sky=None if jsd.sky is None else _np(jsd.sky)), _np(jp), "cpu")
    for f in ("occ_words", "voxels", "mat_params"):
        _equal(getattr(tsd, f), getattr(want_sd, f), f)
    for f in want_sd.tables._fields:
        a, b = getattr(tsd.tables, f), getattr(want_sd.tables, f)
        if f == "grid_res":
            assert a == b
        else:
            _equal(a, b, f)
    assert (tsd.sky is None) == (jsd.sky is None)
    if tsd.sky is not None:
        for f in tsd.sky._fields:
            a, b = getattr(tsd.sky, f), getattr(want_sd.sky, f)
            if isinstance(a, torch.Tensor):
                _equal(a, b, f)
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b)), f
    for f in tp._fields:
        _equal(getattr(tp, f), getattr(want_p, f), f)
