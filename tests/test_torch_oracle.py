"""PyTorch port against the reference's independent oracles: the two float64
numpy path tracers of tests/test_oracle.py (BSDF-sampled transport on the
main.py scene) and tests/test_oracle_nee.py (sun-cone NEE + power-heuristic
MIS on a rough-metal cube), and the seven Disney BSDF properties of
tests/test_bsdf.py, applied to the port on the CPU.

The oracle functions, scenes and sample counts are those modules' own; the
port renders the same scene (its own world, tables and B1 twin; the JAX
package's parameters carried over as numpy) with the same number of samples
a pixel, batched into wavefronts of 16 samples as ``pipeline.accumulate``
batches them. Bars are those tests' own: a per-channel relative gap of 5%
(BSDF transport) and 1% (NEE + MIS). The BSDF properties keep their bars;
their random inputs come from numpy instead of ``jax.random``.
"""

import numpy as np
import pytest
import torch

import test_oracle as orc
import test_oracle_nee as orc_nee

from voxelrt_torch.materials import MaterialList, fetch_material
from voxelrt_torch.ops import bsdf, prng
from voxelrt_torch.ops.accel import add_sun_open_table, build_pallas_tables
from voxelrt_torch.ops.dda_kernel import upload_tables
from voxelrt_torch.ops.sampling import (
    make_orthonormal_basis,
    sample_cosine_weighted_hemisphere,
)
from voxelrt_torch.ops.v3 import V3
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.render import pipeline as tpl
from voxelrt_torch.world import VoxelWorld

# One thread per test process: the suite runs several processes side by
# side.
torch.set_num_threads(1)


def _port_setup(module, voxels):
    """The oracle module's scene on the port: (cfg, SceneData,
    RenderParams); ``voxels``: (ijk, material, colour) of its world."""
    from voxelrt_torch.config import RenderConfig

    jcfg, _, jp = module._make_setup()
    cfg = RenderConfig(image_res=jcfg.image_res, grid_res=jcfg.grid_res,
                       voxel_dx=jcfg.voxel_dx, voxel_edges=0.0,
                       use_directional_light=jcfg.use_directional_light,
                       max_ray_depth=jcfg.max_ray_depth,
                       samples_per_launch=16)
    world = VoxelWorld(cfg.voxel_dx, cfg.grid_res, cfg.voxel_edges)
    world.set_voxels(*voxels)
    arrays = world.device_arrays()
    tables = build_pallas_tables(world.material, arrays["voxels"],
                                 cfg.grid_res)
    if cfg.use_directional_light:
        tables = add_sun_open_table(
            tables, world.material,
            np.asarray(jp.light_direction, np.float64),
            float(jp.light_cone_cos_theta_max))

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())

    scene = tpt.SceneData(occ_words=i32(arrays["occ_words"]),
                          voxels=i32(arrays["voxels"]),
                          mat_params=MaterialList().params("cpu"),
                          tables=upload_tables(tables, "cpu"))
    params = tpt.RenderParams(**{
        f: torch.tensor(np.asarray(getattr(jp, f))) for f in
        tpt.RenderParams._fields})
    return cfg, scene, params


def _render_mean(cfg, scene, params, n_samples):
    """Mean radiance (diffuse + specular) over every pixel and
    ``n_samples`` samples, traced 16 samples a wavefront."""
    k = cfg.samples_per_launch
    u, v, s_of_ray = tpl.wavefront_constants(cfg, 1.0, "cpu")
    acc = torch.zeros(3, dtype=torch.float64)
    for launch in range(n_samples // k):
        skeys, jit = tpl.sample_keys_of(prng.fold_in(prng.key(0), launch), k)
        k0 = torch.tensor([sk[0] for sk in skeys])[s_of_ray]
        k1 = torch.tensor([sk[1] for sk in skeys])[s_of_ray]
        out = tpt.trace_sample(cfg, scene, params, u, v, (k0, k1),
                               (jit[s_of_ray, 0], jit[s_of_ray, 1]))
        rad = out["diffuse"] + out["specular"]
        acc += torch.stack([c.to(torch.float64).mean() for c in rad])
    return (acc / (n_samples // k)).numpy()


def _oracle_gap(module, voxels):
    cfg, scene, params = _port_setup(module, voxels)
    mean_r = _render_mean(cfg, scene, params, n_samples=192)
    proj_inv = np.linalg.inv(np.asarray(params.proj, np.float64))
    view_inv = np.linalg.inv(np.asarray(params.view, np.float64))
    n_pix = cfg.image_res[0] * cfg.image_res[1]
    mean_o = module._oracle_trace(n_pix * 512, 0, proj_inv, view_inv)
    rel = np.abs(mean_r - mean_o) / np.maximum(np.abs(mean_o), 1e-3)
    print(f"{module.__name__}: port {mean_r}, oracle {mean_o}, "
          f"relative gap {rel}")
    return rel


def test_transport_matches_oracle():
    rel = _oracle_gap(orc, (np.array([[0, 0, 0]]), 2, np.array(orc.VOX_COL)))
    assert rel.max() < 0.05, rel


def test_nee_mis_transport_matches_oracle():
    ijk = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    rel = _oracle_gap(orc_nee, (ijk, orc_nee.CUBE_MAT,
                                np.array(orc_nee.CUBE_COL)))
    assert rel.max() < 0.01, rel


# --- the Disney BSDF's properties (tests/test_bsdf.py) ------------------------


def _mat(mat_id, n, albedo=(0.8, 0.6, 0.4)):
    ids = torch.full((n,), mat_id, dtype=torch.int32)
    alb = torch.tensor(albedo, dtype=torch.float32)
    return fetch_material(MaterialList().params("cpu"), ids,
                          V3(*(alb[i].expand(n) for i in range(3))))


def _v3(a):
    a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    nrm = np.tile([0.0, 0.0, 1.0], (n, 1))
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) + 0.05
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    nrm, v = _v3(nrm), _v3(v)
    tang, bitang = make_orthonormal_basis(nrm)
    return nrm, v, tang, bitang


def _unit_dirs(n, seed):
    u = np.random.default_rng(seed).normal(size=(n, 3))
    return _v3(u / np.linalg.norm(u, axis=1, keepdims=True))


def _np3(v):
    return torch.stack(list(v), -1).numpy()


@pytest.mark.parametrize("mat_id", [1, 11, 21, 50, 53])
def test_pdf_mixture_sane(mat_id):
    n = 200_000
    mat = _mat(mat_id, n)
    nrm, v, tang, bitang = _frames(n)
    l = _unit_dirs(n, 42)
    pdf = bsdf.pdf_disney(mat, v, nrm, l, tang, bitang).numpy()
    assert np.isfinite(pdf).all() and (pdf >= 0).all()
    est_d = bsdf.pdf_diffuse(mat, nrm, l).numpy().mean() * 4.0 * np.pi
    assert abs(est_d - 1.0) < 0.02, est_d  # cosine pdf integrates to 1


@pytest.mark.parametrize("mat_id", [1, 21, 50])
def test_sample_matches_pdf(mat_id):
    """The pdf sample_disney reports is pdf_disney_lobewise of the chosen
    lobe at the sampled direction."""
    n = 50_000
    mat = _mat(mat_id, n)
    nrm, v, tang, bitang = _frames(n, seed=1)
    u3 = torch.from_numpy(np.random.default_rng(7).random((n, 3),
                                                          np.float32))
    d, _, pdf, lobe = bsdf.sample_disney(mat, v, nrm, tang, bitang,
                                         (u3[:, 0], u3[:, 1], u3[:, 2]))
    pdf2 = bsdf.pdf_disney_lobewise(mat, v, nrm, d, tang, bitang,
                                    lobe).numpy()
    pdf = pdf.numpy()
    ok = np.isfinite(pdf) & (pdf > 1e-6) & (pdf < 1e6)
    rel = np.abs(pdf[ok] - pdf2[ok]) / np.maximum(pdf[ok], 1e-6)
    assert np.quantile(rel, 0.99) < 1e-3


def test_evaluate_split_consistency():
    """lobewise(LOBE_ALL) equals the full evaluate; the split sums."""
    n = 10_000
    mat = _mat(21, n)
    nrm, v, tang, bitang = _frames(n, seed=2)
    l = _frames(n, seed=3)[1]
    d1, s1 = bsdf.disney_evaluate_split(mat, v, nrm, l, tang, bitang)
    d2, s2 = bsdf.disney_evaluate_lobewise_split(
        mat, v, nrm, l, tang, bitang,
        torch.full((n,), bsdf.LOBE_ALL, dtype=torch.int32))
    assert np.allclose(_np3(d1), _np3(d2), atol=1e-6)
    assert np.allclose(_np3(s1), _np3(s2), atol=1e-6)
    full = bsdf.disney_evaluate(mat, v, nrm, l, tang, bitang)
    assert np.allclose(_np3(full), _np3(d1 + s1), atol=1e-6)


def test_diffuse_white_furnace_bound():
    """Pure diffuse energy: the integral of f cos over the hemisphere stays
    at or below the albedo (sheen about 0, metallic 0)."""
    n = 400_000
    mat = _mat(1, n, albedo=(1.0, 1.0, 1.0))
    nrm, _, tang, bitang = _frames(n, seed=4)
    v = _v3(np.tile([0.0, 0.0, 1.0], (n, 1)))
    u = torch.from_numpy(np.random.default_rng(3).random((n, 2), np.float32))
    l = sample_cosine_weighted_hemisphere(nrm, (u[:, 0], u[:, 1]))
    d, _ = bsdf.disney_evaluate_split(mat, v, nrm, l, tang, bitang)
    refl = np.pi * _np3(d).mean(axis=0)
    assert (refl < 1.15).all(), refl  # retro-reflection can push near 1
    assert (refl > 0.5).all(), refl


def test_lobe_probabilities_normalized():
    for mat_id in [1, 21, 32, 50, 54]:
        dw, sw, cw = bsdf.lobe_probabilities(_mat(mat_id, 4))
        assert np.allclose((dw + sw + cw).numpy(), 1.0, atol=1e-6)


def test_sampled_dirs_unit_length():
    n = 20_000
    mat = _mat(54, n)  # car paint: all three lobes active
    nrm, v, tang, bitang = _frames(n, seed=5)
    u3 = torch.from_numpy(np.random.default_rng(11).random((n, 3),
                                                           np.float32))
    d, brdf, pdf, lobe = bsdf.sample_disney(mat, v, nrm, tang, bitang,
                                            (u3[:, 0], u3[:, 1], u3[:, 2]))
    ln = np.linalg.norm(_np3(d), axis=1)
    # clearcoat half-vector reflection loses ~1e-4 of length in f32
    assert np.abs(ln - 1.0).max() < 1e-3
    assert set(np.unique(lobe.numpy())) <= {0, 1, 2}
    assert np.isfinite(pdf.numpy()).all()
    assert np.isfinite(_np3(brdf)).all()


def test_fused_eval_split_pdf_bitwise():
    """disney_eval_split_pdf equals disney_evaluate_split + pdf_disney
    exactly (the NEE inner loop uses the fused form)."""
    n = 20_000
    for mat_id in [1, 21, 32, 50, 54]:
        mat = _mat(mat_id, n)
        nrm, v, tang, bitang = _frames(n, seed=7)
        l = _unit_dirs(n, 13)
        d0, s0 = bsdf.disney_evaluate_split(mat, v, nrm, l, tang, bitang)
        p0 = bsdf.pdf_disney(mat, v, nrm, l, tang, bitang)
        d1, s1, p1 = bsdf.disney_eval_split_pdf(mat, v, nrm, l, tang, bitang)
        assert np.array_equal(_np3(d0), _np3(d1))
        assert np.array_equal(_np3(s0), _np3(s1))
        assert np.array_equal(np.nan_to_num(p0.numpy()),
                              np.nan_to_num(p1.numpy()))
