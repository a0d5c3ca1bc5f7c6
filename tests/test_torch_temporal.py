"""PyTorch port, the moving-frame pipeline step: ``reset_framebuffer``,
``wavefront_constants`` at render scale 0.5 and one
``accumulate_n(moving=True, render_scale=0.5)`` step against the JAX package
under ``app/testing.production_test_config`` (64x32, active 32x16; Pallas
kernels in interpret mode, Catmull-Rom history taps through kernel B4's
plain twin on the port's side).

Both packages start the compared step from the SAME state: the JAX package
renders one moving frame from an empty state, and that state is carried
over with ``interop.render_state_from_jax``; then each renders the next
moving frame (camera moved again, previous matrices of the frame before).

Tolerances. Out of the active area every buffer equals the JAX package's
exactly, and every G-buffer equals the input state exactly (the temporal
filters of both packages run over the whole image, so colour and history do
change there, identically). In the active area every field agrees to rtol
1e-5 / atol 1e-6 on at least 99.5% of pixels (float32 last-bit differences
between XLA's CPU kernels and torch's; rarely a flipped gate or discrete
choice moves a pixel further), except the two reflection depths: they are
linearized depths of points up to 1e4 away, near the far plane, where a last
bit is 1e-2 relative (rtol 2e-2 on 99%, as tests/test_torch_render.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import build_both

from voxelrt.app import testing
from voxelrt.render import pipeline as jpl

from voxelrt_torch import interop
from voxelrt_torch.ops import prng
from voxelrt_torch.render import pipeline as tpl

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

SCALE = 0.5
AW, AH = 32, 16


@pytest.fixture(scope="module")
def both():
    return build_both()


def _state_np(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields
            if f != "reservoirs"}


def _moved(cfg, prev, camera_pos, look_at):
    """Params at a new pose whose previous matrices are ``prev``'s."""
    p = testing.make_params(cfg, camera_pos=camera_pos, look_at=look_at)
    return p._replace(prev_proj=prev.proj, prev_view=prev.view,
                      prev_camera_pos=prev.camera_pos,
                      max_accum_frames=jnp.float32(50.0))


def _port_params(p, tp):
    """The port's RenderParams for the JAX params ``p`` (scene unchanged)."""
    d = {}
    for f in tp._fields:
        a = np.asarray(getattr(p, f))
        d[f] = torch.tensor(a.astype(
            np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32))
    return type(tp)(**d)


def test_wavefront_constants_scaled(both):
    cfg, _, _, tcfg, _, _ = both
    for spl in (1, 3):
        jc = dataclasses.replace(cfg, samples_per_launch=spl)
        tc = dataclasses.replace(tcfg, samples_per_launch=spl)
        ju, jv, js, juu, jvv = jpl.wavefront_constants(jc, SCALE)
        tu, tv, ts = tpl.wavefront_constants(tc, SCALE, "cpu")
        assert tu.shape[0] == spl * AW * AH
        if spl == 1:
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        else:
            np.testing.assert_array_equal(tu.numpy(), np.asarray(juu))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jvv))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # a size that does not tile 16x8 falls to column order in both
    jc = dataclasses.replace(cfg, image_res=(50, 30))
    tc = dataclasses.replace(tcfg, image_res=(50, 30))
    ju, jv = jpl.wavefront_constants(jc, SCALE)[:2]
    tu, tv, _ = tpl.wavefront_constants(tc, SCALE, "cpu")
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_reset_framebuffer(both):
    _, _, _, tcfg, _, _ = both
    st = tpl.init_state(tcfg, "cpu")
    g = torch.Generator().manual_seed(0)
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
            setattr(st, f.name, torch.rand(v.shape, generator=g).to(v.dtype))
    st.gbuff_mat_id = torch.full_like(st.gbuff_mat_id, 0x80FF4001)
    st.spp, st.frame = 7, 9
    before = dataclasses.replace(st)
    out = tpl.reset_framebuffer(st)
    zeroed = {"history", "history_spec", "history_spec_depth"}
    for f in dataclasses.fields(st):
        a, b = getattr(out, f.name), getattr(before, f.name)
        if f.name in zeroed:
            assert (a == 0).all() and a.shape == b.shape
        elif f.name == "spp":
            assert a == 0
        elif isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    # the input state is left as it was
    assert torch.equal(st.history, before.history) and st.spp == 7


def test_moving_accumulate_step(both):
    cfg, sd, p0, tcfg, tsd, tp0 = both
    assert cfg.samples_per_launch == 1 and cfg.motion_filter == "catmullrom"
    # the shared state: one moving frame from an empty state (JAX)
    p1 = _moved(cfg, p0, (0.43, 0.52, 1.96), (0.01, 0.0, 0.0))
    st = jpl.accumulate_n(cfg, sd, p1, jpl.init_state(cfg),
                          jax.random.PRNGKey(6), True, SCALE, 1)
    shared = _state_np(st)
    assert shared["history"][:AW, :AH, 3].max() >= 1.0
    p2 = _moved(cfg, p1, (0.46, 0.54, 1.92), (0.02, 0.0, 0.0))

    # the compared step (the JAX call donates its state: it goes last)
    ts = tpl.accumulate_n(tcfg, tsd, _port_params(p2, tp0),
                          interop.render_state_from_jax(shared, "cpu"),
                          prng.key(7), True, SCALE, 1)
    js = _state_np(jpl.accumulate_n(cfg, sd, p2, st, jax.random.PRNGKey(7),
                                    True, SCALE, 1))

    assert ts.spp == js["spp"] and ts.frame == js["frame"] == 2
    gbuffers = {f.name for f in dataclasses.fields(ts)
                if f.name.startswith("gbuff_")}
    refl = {"gbuff_depth_reflection", "history_spec_depth"}
    outside = np.ones(cfg.image_res, bool)
    outside[:AW, :AH] = False
    for f in dataclasses.fields(ts):
        if f.name in ("spp", "frame", "reservoirs"):
            continue
        a = getattr(ts, f.name).numpy()
        b = js[f.name]
        if f.name == "gbuff_mat_id":
            b = b.astype(np.int64)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a[outside], b[outside], f.name)
        if f.name in gbuffers:
            np.testing.assert_array_equal(
                a[outside], shared[f.name].astype(a.dtype)[outside], f.name)
        ia = a[:AW, :AH].astype(np.float64).reshape(AW * AH, -1)
        ib = b[:AW, :AH].astype(np.float64).reshape(AW * AH, -1)
        assert np.isfinite(ia).all(), f.name
        if f.name in refl:
            ok = np.isclose(ia, ib, rtol=2e-2, atol=1e-4).all(-1)
            assert ok.mean() >= 0.99, (f.name, ok.mean())
        else:
            ok = np.isclose(ia, ib, rtol=1e-5, atol=1e-6).all(-1)
            assert ok.mean() >= 0.995, (f.name, ok.mean())
    # the history really was reprojected: active pixels carry its weight
    w_act = ts.history.numpy()[:AW, :AH, 3]
    assert (w_act >= 2.0).mean() > 0.3
