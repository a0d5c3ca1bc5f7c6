"""PyTorch port, kernel B4 (temporal resample): ``ops/resample`` and
``render/temporal._moving_taps`` against the JAX package on the inputs of
tests/test_resample.py (64x48 at render scale 0.5, seed 5), for both tap
filters and both passes (depth gate without extra = diffuse, extra without
depth gate = specular).

The JAX side runs its Pallas kernel in interpret mode on words packed by its
own ``pack2_bf16``; the port hands the frame buffers' views to the kernel's
plain twin on the CPU, which packs them itself. Tolerances: the packed bf16
words are exact.
Twin against Pallas kernel, and gather path against gather path, share their
sources and their arithmetic, so outputs agree to rtol 1e-5 / atol 1e-6 on
at least 99.5% of pixels; the rest is a normal or depth gate flipped by a
last-bit difference (``rsqrt``, a division), which moves a pixel by a whole
tap weight. Twin against the port's own gather path differs by the bf16
quantisation of the sources: the bars of tests/test_resample.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_resample import _Params, _setup

from voxelrt.config import RenderConfig as JCfg
from voxelrt.ops import resample as jrs
from voxelrt.ops.packing import encode_unit_vector_3x16 as jpack_encode
from voxelrt.ops.transforms import linearize_depth as jtr_lin
from voxelrt.render import temporal as jtemporal

from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import _cuda
from voxelrt_torch.ops import resample as trs
from voxelrt_torch.render import temporal as ttemporal

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

VARIANTS = [(f, g, e) for f in ("bilinear", "catmullrom")
            for g, e in ((True, False), (False, True))]
IDS = [f"{f}-{'diffuse' if g else 'specular'}" for f, g, e in VARIANTS]


class _TParams:
    proj_inv = torch.tensor(np.asarray(_Params.proj_inv))


def _t(x):
    return torch.tensor(np.asarray(x))


def _run_jax(mode, filt, gate_depth, extra_on):
    cfg = JCfg(image_res=(64, 48), use_pallas_dda=True, pallas_interpret=True,
               motion_resample=mode, motion_filter=filt)
    color, history, gbuffer, tx, rp, cd, cn, sd = _setup(5)
    return jtemporal._moving_taps(cfg, _Params, color, history, gbuffer, tx,
                                  rp, cd, cn, 0.5, gate_depth=gate_depth,
                                  extra=(sd if extra_on else None))


def _run_torch(mode, filt, gate_depth, extra_on):
    cfg = TCfg(image_res=(64, 48), motion_resample=mode, motion_filter=filt)
    color, history, gbuffer, tx, rp, cd, cn, sd = _setup(5)
    gb = {k: _t(v) for k, v in gbuffer.items()}
    return ttemporal._moving_taps(cfg, _TParams, _t(color), _t(history), gb,
                                  _t(tx), _t(rp), _t(cd), _t(cn), 0.5,
                                  gate_depth=gate_depth,
                                  extra=(_t(sd) if extra_on else None))


def _outside(a, b, rtol, atol):
    """Share of pixels with any component outside the tolerance."""
    a, b = np.asarray(a), np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    if bad.ndim == 3:
        bad = bad.any(-1)
    return float(bad.mean())


def _hold(t_out, j_out, extra_on, rtol, atol, max_frac, label):
    names = ("current", "w_sum", "hist", "extra")
    for name, a, b in zip(names, t_out, j_out):
        if name == "extra" and not extra_on:
            assert a is None and b is None
            continue
        frac = _outside(a.numpy(), b, rtol, atol)
        assert frac <= max_frac, f"{label} {name}: {frac:.3%} outside"


def test_pack2_bf16_words_exact():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(
        np.float32)
    b = rng.normal(size=4096).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        3.4028235e38, -3.4028235e38, 1e-45, -1e-45,
                        1.0039062, 1.0117188, -1.0039062, 65280.0],
                       np.float32)
    # every bit pattern near the rounding carry into the sign bit as well
    carry = np.array([0x7F7FFFFF, 0x7FFFFFFF, 0xFFFFFFFF, 0xFFFF8000,
                      0x7FFF7FFF, 0x00008000, 0x00018000, 0x80008000],
                     np.uint32).view(np.float32)
    a[:len(special)] = special
    b[:len(special)] = special[::-1]
    a[100:100 + len(carry)] = carry
    b[200:200 + len(carry)] = carry
    want = np.asarray(jrs.pack2_bf16(jnp.asarray(a), jnp.asarray(b)))
    got = trs.pack2_bf16(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_moving_transforms_and_packing_match_jax():
    """The packed-image forms the moving filters add: transforms to rtol
    1e-6 (explicit multiply-adds in the same order; a division's last bit),
    the octahedral encode and the material-word decode exactly."""
    from voxelrt.camera import look_at_matrix, perspective_matrix
    from voxelrt.ops import packing as jpack, transforms as jtr
    from voxelrt_torch.ops import packing as tpack, transforms as ttr

    rng = np.random.default_rng(2)
    proj = np.asarray(perspective_matrix(0.9, 16 / 9, 0.01, 10.0), np.float32)
    view = np.asarray(look_at_matrix((0.4, 0.5, 2.0), (0, 0, 0), (0, 1, 0)),
                      np.float32)
    pos = (rng.normal(size=(16, 8, 3)) * 0.5).astype(np.float32)
    lin = np.concatenate([[0.0], -rng.random(127) * 9.0 - 0.02]).astype(
        np.float32).reshape(16, 8)
    jv = jtr.world_to_view(jnp.asarray(pos), jnp.asarray(view))
    tv = ttr.world_to_view(_t(pos), _t(view))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        ttr.view_to_screen(tv, _t(proj)).numpy(),
        np.asarray(jtr.view_to_screen(jv, jnp.asarray(proj))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        ttr.delinearize_depth(_t(lin), _t(proj)).numpy(),
        np.asarray(jtr.delinearize_depth(jnp.asarray(lin),
                                         jnp.asarray(proj))), rtol=1e-6)
    nrm = rng.normal(size=(16, 8, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    enc = tpack.encode_unit_vector_3x16(_t(nrm))
    assert enc.dtype == torch.float16 and enc.shape == (16, 8, 2)
    want = np.asarray(jpack.encode_unit_vector_3x16(jnp.asarray(nrm)))
    assert (enc.numpy() == want).mean() >= 0.99
    words = rng.integers(0, 2 ** 32, size=(16, 8), dtype=np.uint64)
    tm, ta = tpack.decode_material_word(_t(words.astype(np.int64)))
    jm, ja = jpack.decode_material_word(jnp.asarray(words.astype(np.uint32)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_twin_matches_pallas_kernel(filt, gate_depth, extra_on):
    t_out = _run_torch("pallas", filt, gate_depth, extra_on)
    j_out = _run_jax("pallas", filt, gate_depth, extra_on)
    _hold(t_out, j_out, extra_on, 1e-5, 1e-6, 0.005, "twin vs pallas")


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_gather_path_matches_jax(filt, gate_depth, extra_on):
    t_out = _run_torch("xla", filt, gate_depth, extra_on)
    j_out = _run_jax("xla", filt, gate_depth, extra_on)
    _hold(t_out, j_out, extra_on, 1e-5, 1e-6, 0.005, "gather vs gather")


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_twin_matches_gather_path_within_bf16(filt, gate_depth, extra_on):
    cur_p, ws_p, hist_p, ex_p = _run_torch("pallas", filt, gate_depth,
                                           extra_on)
    cur_x, ws_x, hist_x, ex_x = _run_torch("xla", filt, gate_depth, extra_on)

    def close(a, b, rtol, atol, name):
        frac = float((~np.isclose(a.numpy(), b.numpy(), rtol=rtol,
                                  atol=atol)).mean())
        assert frac <= 0.01, f"{name}: {frac:.2%} outside tolerance"

    close(ws_p, ws_x, 1e-5, 1e-3, "w_sum")
    close(cur_p, cur_x, 0.01, 0.02, "current")
    close(hist_p, hist_x, 0.01, 0.03, "hist")
    if extra_on:
        close(ex_p, ex_x, 0.01, 0.05, "extra")


def test_dispatch_rule_follows_config_not_device():
    """Above the texel limit, and for motion_resample='xla', the gather path
    runs; the kernel path otherwise. The wrapper is reached exactly then."""
    calls = []
    orig = ttemporal.temporal_taps

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    ttemporal.temporal_taps = spy
    try:
        _run_torch("pallas", "bilinear", True, False)
        assert len(calls) == 1
        _run_torch("xla", "bilinear", True, False)
        assert len(calls) == 1
        saved = trs.MAX_TEXELS
        trs.MAX_TEXELS = 32 * 24 - 1
        try:
            _run_torch("pallas", "bilinear", True, False)
        finally:
            trs.MAX_TEXELS = saved
        assert len(calls) == 1
    finally:
        ttemporal.temporal_taps = orig
    assert trs.MAX_TEXELS == jrs.MAX_TEXELS == 530_000
    # the CPU path launches no kernel
    assert _cuda.LAUNCHES["temporal_taps"] == 0


def _jax_taps(src, lanes, filt, gate_depth, extra_on):
    """The JAX package's interpret-mode ``temporal_taps`` on the active
    region of ``src``, its tables packed by its own ``pack2_bf16``, its
    per-lane coordinates formed as its ``_moving_taps`` forms them. Returns
    numpy outputs shaped as the port's."""
    cur, hist, nrm, dep, ext = (src[k] for k in ("cur", "hist", "normals",
                                                 "depth", "extra"))
    aw, ah = cur.shape[:2]
    tc, rp, cd, cn = (lanes[k] for k in ("texcoord", "rp", "cd", "cn"))
    w, h = tc.shape[:2]
    pk = jrs.pack2_bf16

    def flat(x):
        return jnp.asarray(np.ascontiguousarray(x)).reshape(-1)

    cur_p = jnp.stack([pk(flat(cur[..., 0]), flat(cur[..., 1])),
                       pk(flat(cur[..., 2]), jnp.zeros(aw * ah))])
    hist_p = jnp.stack([pk(flat(hist[..., 0]), flat(hist[..., 1])),
                        pk(flat(hist[..., 2]), flat(hist[..., 3]))])
    pn_p = pk(flat(nrm[..., 0]).astype(jnp.float32),
              flat(nrm[..., 1]).astype(jnp.float32))
    pd = flat(jtr_lin(jnp.asarray(dep), _Params.proj_inv)) if gate_depth \
        else None
    out = jrs.temporal_taps(
        cur_p, hist_p, pn_p, pd, flat(ext) if extra_on else None,
        flat(tc[..., 0] * aw - 0.5), flat(tc[..., 1] * ah - 0.5),
        flat(rp[..., 0] * aw - 0.5), flat(rp[..., 1] * ah - 0.5),
        flat(cd), jnp.asarray(cn).reshape(-1, 3), ires_x=aw, ires_y=ah,
        catmullrom=filt != "bilinear", gate_depth=gate_depth,
        interpret=True)
    shapes = ((w, h, 3), (w, h), (w, h, 4), (w, h))
    return [None if o is None else np.asarray(o).reshape(s)
            for o, s in zip(out, shapes)]


def _torch_taps(src, lanes, filt, gate_depth, extra_on):
    """The port's ``temporal_taps`` on views of ``src``'s full buffers."""
    full = {k: _t(v) for k, v in src["full"].items()}
    aw, ah = src["cur"].shape[:2]
    return trs.temporal_taps(
        full["cur"][:aw, :ah], full["hist"][:aw, :ah],
        full["normals"][:aw, :ah], full["depth"][:aw, :ah],
        _TParams.proj_inv, full["extra"][:aw, :ah] if extra_on else None,
        *(_t(lanes[k]) for k in ("texcoord", "rp", "cd", "cn")),
        catmullrom=filt != "bilinear", gate_depth=gate_depth)


def _synthetic(seed, w=24, h=20, aw=14, ah=9, full=(19, 13)):
    """Sources as views of larger frame buffers (row stride full[1] > ah),
    f16 normals, and lanes whose reprojection is NaN, infinite or far off
    the region beside ordinary ones."""
    rng = np.random.default_rng(seed)
    fw, fh = full
    n = rng.normal(size=(fw, fh, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    bufs = dict(
        cur=rng.random((fw, fh, 3)).astype(np.float32) * 4.0,
        hist=rng.random((fw, fh, 4)).astype(np.float32) * 3.0,
        normals=np.asarray(jpack_encode(jnp.asarray(n))),
        depth=rng.random((fw, fh)).astype(np.float32) * 0.9 + 0.05,
        extra=rng.random((fw, fh)).astype(np.float32) * 5.0)
    assert bufs["normals"].dtype == np.float16
    src = {k: v[:aw, :ah] for k, v in bufs.items()}
    src["full"] = bufs
    tc = np.stack(np.meshgrid((np.arange(w) + 0.5) / (2 * aw),
                              (np.arange(h) + 0.5) / (2 * ah),
                              indexing="ij"), -1).astype(np.float32)
    # the previous frame a little shifted, as a moving camera gives
    rp = np.concatenate([tc * 0.5 + 0.01, np.zeros((w, h, 1), np.float32)],
                        -1)
    rp[..., :2] += (rng.normal(size=(w, h, 2)) * 0.02).astype(np.float32)
    odd = rng.random((w, h))
    rp[odd < 0.05, 0] = np.nan
    rp[(odd >= 0.05) & (odd < 0.08), 1] = np.inf
    rp[(odd >= 0.08) & (odd < 0.11), 0] = -np.inf
    rp[(odd >= 0.11) & (odd < 0.15), 1] = 4.0e7
    rp[(odd >= 0.15) & (odd < 0.19), 0] = -3.0
    cn = rng.normal(size=(w, h, 3)).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=-1, keepdims=True)
    # centre depths near the previous ones, so the depth gate passes some
    lin = np.asarray(jtr_lin(jnp.asarray(bufs["depth"]), _Params.proj_inv))
    cd = lin[np.clip((np.arange(w) // 2), 0, fw - 1)][
        :, np.clip(np.arange(h) // 2, 0, fh - 1)] * (
        1.0 + (rng.random((w, h)) - 0.5) * 0.08).astype(np.float32)
    lanes = dict(texcoord=tc, rp=rp.astype(np.float32),
                 cd=cd.astype(np.float32), cn=cn)
    return src, lanes


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_twin_matches_pallas_on_strided_views(filt, gate_depth, extra_on):
    """The twin on views of larger buffers (h > ah), f16 normals and NaN,
    infinite and far reprojections, against the interpret-mode Pallas
    kernel fed the JAX package's own packed words."""
    src, lanes = _synthetic(11)
    t_out = _torch_taps(src, lanes, filt, gate_depth, extra_on)
    j_out = _jax_taps(src, lanes, filt, gate_depth, extra_on)
    for a, b in zip(t_out, j_out):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape
    _hold(t_out, j_out, extra_on, 1e-5, 1e-6, 0.005, "strided twin")
    # the odd lanes reach the clamp's floor as the Pallas kernel's do
    far = ~np.isfinite(lanes["rp"][..., :2]).all(-1)
    np.testing.assert_array_equal(t_out[1].numpy()[far], j_out[1][far])


def test_no_in_bounds_tap_clamps_to_floor():
    """A pixel whose taps are all out of bounds (or whose history coords are
    not finite) has lo > hi in the clamp: the result is (0, 0, 0, 1) and an
    extra of 0, with w_sum 0, in the twin as in the Pallas kernel."""
    rng = np.random.default_rng(1)
    src = dict(cur=rng.random((8, 8, 3)).astype(np.float32),
               hist=rng.random((8, 8, 4)).astype(np.float32),
               normals=rng.random((8, 8, 2)).astype(np.float16),
               depth=rng.random((8, 8)).astype(np.float32),
               extra=rng.random((8, 8)).astype(np.float32))
    src["full"] = dict(src)
    fxc = np.linspace(0.0, 7.0, 6).astype(np.float32)
    fyc = np.linspace(7.0, 0.0, 6).astype(np.float32)
    fxh = np.array([np.nan, np.inf, -np.inf, -50.0, 1e9, 3.0], np.float32)
    fyh = np.array([3.0, 3.0, 3.0, 3.0, 3.0, 400.0], np.float32)
    lanes = dict(
        texcoord=np.stack([(fxc + 0.5) / 8, (fyc + 0.5) / 8], -1).reshape(
            2, 3, 2),
        rp=np.stack([(fxh + 0.5) / 8, (fyh + 0.5) / 8,
                     np.zeros(6, np.float32)], -1).reshape(2, 3, 3),
        cd=np.ones((2, 3), np.float32),
        cn=np.tile(np.array([0.0, 0.0, 1.0], np.float32), (2, 3, 1)))
    for cat in ("bilinear", "catmullrom"):
        cur_t, ws_t, hist_t, ex_t = _torch_taps(src, lanes, cat, False, True)
        cur_j, ws_j, hist_j, ex_j = _jax_taps(src, lanes, cat, False, True)
        assert (ws_t.numpy() == 0.0).all()
        np.testing.assert_array_equal(
            hist_t.numpy(), np.tile([0.0, 0.0, 0.0, 1.0], (2, 3, 1)))
        assert (ex_t.numpy() == 0.0).all()
        np.testing.assert_array_equal(hist_t.numpy(), hist_j)
        np.testing.assert_array_equal(ex_t.numpy(), ex_j)
        np.testing.assert_allclose(cur_t.numpy(), cur_j, rtol=1e-6,
                                   atol=1e-7)


def _bits(t):
    return None if t is None else t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_cuda_kernel_matches_twin(filt, gate_depth, extra_on):
    """On a CUDA card: the hand-written kernel against its twin on the same
    device, same inputs, every output bit-equal (the kernel is built
    without multiply-add contraction and runs the twin's float32
    operations in the same order): on ``_moving_taps``' own call, and on a
    synthetic call whose reprojections spread each block's taps beyond its
    shared-memory box, so that both of the kernel's routes run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    color, history, gbuffer, tx, rp, cd, cn, sd = _setup(5)
    cfg = TCfg(image_res=(64, 48), motion_filter=filt)
    gb = {k: _t(v).to(dev) for k, v in gbuffer.items()}
    seen = []
    orig = ttemporal.temporal_taps

    def spy(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    ttemporal.temporal_taps = spy
    before = _cuda.LAUNCHES["temporal_taps"]
    try:
        k_out = ttemporal._moving_taps(
            cfg, dataclasses.make_dataclass("P", ["proj_inv"])(
                _TParams.proj_inv.to(dev)),
            _t(color).to(dev), _t(history).to(dev), gb, _t(tx).to(dev),
            _t(rp).to(dev), _t(cd).to(dev), _t(cn).to(dev), 0.5,
            gate_depth=gate_depth,
            extra=(_t(sd).to(dev) if extra_on else None))
    finally:
        ttemporal.temporal_taps = orig
    assert _cuda.LAUNCHES["temporal_taps"] == before + 1
    a, k = seen[0]
    p_out = trs.temporal_taps_plain(*a, **k)
    shapes = ((64, 48, 3), (64, 48), (64, 48, 4), (64, 48))
    for kk, pp, shp in zip(k_out, p_out, shapes):
        assert (kk is None) == (pp is None)
        if kk is not None:
            assert kk.shape == shp
            assert torch.equal(_bits(kk), _bits(pp))
    # a sudden turn on the left half: those blocks' boxes overflow shared
    # memory; the right half's sky and far lanes leave their blocks' boxes
    src, lanes = _synthetic(3, w=96, h=64, aw=60, ah=40, full=(70, 50))
    jitter = np.random.default_rng(4).normal(size=(48, 64, 2)) * 0.8
    lanes["rp"][:48, :, :2] += jitter.astype(np.float32)
    full = {k: _t(v).to(dev) for k, v in src["full"].items()}
    views = (full["cur"][:60, :40], full["hist"][:60, :40],
             full["normals"][:60, :40], full["depth"][:60, :40],
             _TParams.proj_inv.to(dev),
             full["extra"][:60, :40] if extra_on else None,
             *(_t(lanes[k]).to(dev) for k in ("texcoord", "rp", "cd", "cn")))
    kw = dict(catmullrom=filt != "bilinear", gate_depth=gate_depth)
    routes = torch.zeros(4, dtype=torch.int32, device=dev)
    k_out = trs.temporal_taps(*views, **kw, counts=routes)
    p_out = trs.temporal_taps_plain(*views, **kw)
    blocks, box_global, lanes_global, staged = routes.tolist()
    assert blocks == 2 * 12 and 0 < box_global < blocks, routes
    assert lanes_global > box_global * 256, routes
    assert 0 < staged <= (blocks - box_global) * 1024, routes
    for kk, pp in zip(k_out, p_out):
        assert (kk is None) == (pp is None)
        if kk is not None:
            assert torch.equal(_bits(kk), _bits(pp))
