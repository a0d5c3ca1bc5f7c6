"""PyTorch port: checkpoint/resume of progressive renders
(``voxelrt_torch.utils.checkpoint`` and ``HeadlessRenderer.render``'s
``checkpoint_every``/``checkpoint_path``/``resume_from``) against the JAX
package's semantics (tests/test_checkpoint.py) and its file format.

In the port a killed and resumed render reproduces the uninterrupted image
bit for bit, with ReSTIR off and on. Across packages a checkpoint written by
either one resumes in the other: the resumed image is held to the writer's
uninterrupted image with 100% of pixels within 1e-4, the bar the port's
image comparisons with the JAX package meet (the JAX package traces with
its portable traversal on the CPU, the port with its B1 twin, and float32
last bits differ)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.app import testing as jtesting
from voxelrt.app.headless import HeadlessRenderer as JRenderer
from voxelrt.camera import Camera as JCamera
from voxelrt.render import pipeline as jpl
from voxelrt.utils import checkpoint as jck

from voxelrt_torch.app import testing
from voxelrt_torch.app.headless import HeadlessRenderer
from voxelrt_torch.camera import Camera
from voxelrt_torch.render import pipeline as tpl
from voxelrt_torch.utils import checkpoint as ck

torch.set_num_threads(1)


class _FakeScene:
    """Minimal Scene stand-in for driving a HeadlessRenderer directly (as
    tests/test_checkpoint.py has it)."""

    def __init__(self, cfg, world, camera):
        self.config = cfg
        self.world = world
        self.camera = camera  # default pose (0.4, 0.5, 2.0) -> origin
        self._fov = np.radians(50.0)
        light = np.array([1.0, 1.0, 1.0])
        self._light_direction = light / np.linalg.norm(light)
        self._light_cone_cos_theta_max = np.cos(0.05)
        self._light_color = np.array([1.0, 0.95, 0.9])
        self._floor_height = -0.1
        self._floor_color = np.array([0.8, 0.8, 0.85])
        self._floor_material = 1
        self._background_color = np.array([0.2, 0.3, 0.5])


def _port(cfg, seed=3):
    r = HeadlessRenderer(cfg, _FakeScene(cfg, testing.make_test_world(cfg),
                                         Camera()), seed=seed, quiet=True,
                         device="cpu")
    r.prepare_data()
    return r


def _jax(cfg, seed=3):
    jcfg = jtesting.tiny_config(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    r = JRenderer(jcfg, _FakeScene(jcfg, jtesting.make_test_world(jcfg),
                                   JCamera()), seed=seed, quiet=True)
    r.prepare_data()
    return r


@pytest.mark.parametrize("restir", [False, True])
def test_kill_and_resume_reproduces_uninterrupted(tmp_path, restir):
    over = dict(use_restir_pt=True, restir_taps=2, restir_radius=4.0) \
        if restir else {}
    cfg = testing.tiny_config(image_res=(48, 24), **over)
    spp, chunk = (4, 2) if restir else (8, 2)
    img_full = _port(cfg).render(spp=spp, chunk=chunk)

    ck_path = str(tmp_path / "render.npz")
    r1 = _port(cfg)
    r1.render(spp=spp // 2, chunk=chunk, log_every=10**9)
    # render() only checkpoints mid-run; write the state as a periodic
    # checkpoint at done = spp/2 of a longer run would be written
    ck.save_render_state(ck_path, r1.state, r1.key, r1._frame,
                         extra={"done": spp // 2})
    del r1
    r2 = _port(cfg)
    img_resumed = r2.render(spp=spp, chunk=chunk, resume_from=ck_path)
    assert np.array_equal(img_resumed, img_full)
    assert r2.state.spp == spp
    if restir:
        assert r2.state.reservoirs is not None


def test_mid_run_checkpoint_is_written_and_loadable(tmp_path):
    cfg = testing.tiny_config(image_res=(48, 24))
    ck_path = str(tmp_path / "mid.npz")
    r = _port(cfg)
    r.render(spp=18, chunk=6, checkpoint_every=6, checkpoint_path=ck_path,
             log_every=10**9)
    state, key, frame, extra = ck.load_render_state(
        ck_path, tpl.init_state(cfg, "cpu"))
    assert int(extra["done"]) == 12  # the last mid-run boundary before 18
    assert frame == 12 and state.spp == 12 and state.frame == 12
    assert key == r.key
    assert state.color.shape == (48, 24, 3)
    assert torch.isfinite(state.color).all()


def test_file_is_in_the_jax_format(tmp_path):
    """Keys and dtypes on disk are the JAX package's (reservoirs included):
    a port file loads through voxelrt.utils.checkpoint into the JAX
    package's init_state template with every array equal, and a JAX file
    loads into the port's."""
    cfg = testing.tiny_config(image_res=(16, 8), use_restir_pt=True)
    rng = np.random.default_rng(0)
    st = tpl.init_state(cfg, "cpu")

    def rand(t):
        if t.dtype == torch.int64:  # u32 words
            return torch.from_numpy(rng.integers(0, 2**32, t.shape))
        if t.dtype == torch.int32:
            return torch.from_numpy(rng.integers(0, 99, t.shape, np.int32))
        return torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype)

    st = dataclasses.replace(
        st, **{f.name: rand(getattr(st, f.name))
               for f in dataclasses.fields(st)
               if isinstance(getattr(st, f.name), torch.Tensor)},
        reservoirs=tuple({k: rand(v) for k, v in slot.items()}
                         for slot in st.reservoirs), spp=5, frame=7)
    path = str(tmp_path / "port.npz")
    ck.save_render_state(path, st, (0x12345678, 0x9ABCDEF0), 7,
                         extra={"done": 5})
    jcfg = jtesting.tiny_config(image_res=(16, 8), use_restir_pt=True)
    jst, jkey, frame, extra = jck.load_render_state(path, jpl.init_state(jcfg))
    assert frame == 7 and int(extra["done"]) == 5
    assert jkey.dtype == jnp.uint32
    assert [int(x) for x in np.asarray(jkey)] == [0x12345678, 0x9ABCDEF0]
    tmpl = jpl.init_state(jcfg)
    for f in jpl.RenderState._fields:
        if f == "reservoirs":
            continue
        a, t = np.asarray(getattr(jst, f)), np.asarray(getattr(tmpl, f))
        assert a.dtype == t.dtype and a.shape == t.shape, f
        want = getattr(st, f)
        want = np.asarray(want, np.int32) if f in ("spp", "frame") else \
            want.numpy().astype(t.dtype)
        assert np.array_equal(a, want), f
    for js, ts, tt in zip(jst.reservoirs, st.reservoirs, tmpl.reservoirs):
        for k, v in ts.items():
            a = np.asarray(js[k])
            assert a.dtype == np.asarray(tt[k]).dtype, k
            assert np.array_equal(a, v.numpy().astype(a.dtype)), k

    # and back: the JAX package writes, the port reads
    path2 = str(tmp_path / "jax.npz")
    jck.save_render_state(path2, jst, jkey, 7, extra={"done": 5})
    back, key, frame, extra = ck.load_render_state(
        path2, tpl.init_state(cfg, "cpu"))
    assert key == (0x12345678, 0x9ABCDEF0) and frame == 7
    for f in dataclasses.fields(st):
        a, b = getattr(back, f.name), getattr(st, f.name)
        if f.name == "reservoirs":
            for sa, sb in zip(a, b):
                for k in sb:
                    assert sa[k].dtype == sb[k].dtype and torch.equal(
                        sa[k], sb[k]), k
        elif isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_wrong_shape_raises(tmp_path):
    cfg = testing.tiny_config(image_res=(16, 8))
    path = str(tmp_path / "small.npz")
    ck.save_render_state(path, tpl.init_state(cfg, "cpu"), (0, 1), 0)
    bigger = testing.tiny_config(image_res=(32, 8))
    with pytest.raises(ValueError, match="shape"):
        ck.load_render_state(path, tpl.init_state(bigger, "cpu"))
    with pytest.raises(ValueError, match="reservoirs"):
        ck.load_render_state(path, tpl.init_state(
            testing.tiny_config(image_res=(16, 8), use_restir_pt=True), "cpu"))


@pytest.fixture(scope="module")
def cross():
    """The JAX package's uninterrupted image, on its own route for the CPU
    (the portable traversal; the port traces with its B1 twin)."""
    cfg = testing.tiny_config(image_res=(48, 24))
    spp, chunk = 4, 2
    img = _jax(cfg).render(spp=spp, chunk=chunk)
    return cfg, spp, chunk, img


def _close(a, b):
    ok = np.abs(a - b) <= 1e-4
    return float(ok.mean())


def test_jax_checkpoint_resumes_in_the_port(tmp_path, cross):
    cfg, spp, chunk, jimg = cross
    path = str(tmp_path / "jax.npz")
    jr = _jax(cfg)
    jr.render(spp=spp // 2, chunk=chunk, log_every=10**9)
    jck.save_render_state(path, jr.state, jr.key, jr._frame,
                          extra={"done": spp // 2})
    img = _port(cfg).render(spp=spp, chunk=chunk, resume_from=path)
    assert img.shape == jimg.shape and img.std() > 0.01
    assert _close(img, jimg) == 1.0


def test_port_checkpoint_resumes_in_jax(tmp_path, cross):
    cfg, spp, chunk, jimg = cross
    path = str(tmp_path / "port.npz")
    r = _port(cfg)
    r.render(spp=spp, chunk=chunk, checkpoint_every=chunk,
             checkpoint_path=path, log_every=10**9)
    timg = r.fetch_image()
    assert _close(timg, jimg) == 1.0
    # the file holds done = 2 of 4; the JAX package resumes from it
    jst, _, frame, extra = jck.load_render_state(
        path, jpl.init_state(jtesting.tiny_config(image_res=cfg.image_res)))
    assert int(extra["done"]) == spp // 2 and frame == spp // 2
    img = _jax(cfg).render(spp=spp, chunk=chunk, resume_from=path)
    assert _close(img, jimg) == 1.0
