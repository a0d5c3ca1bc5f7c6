"""PyTorch port, kernel P: the plain PyTorch version of the loop-construct
probe (voxelrt_torch/ops/probe.py) against the TPU probe kernel of
tools/pallas_probe.py, run in interpret mode on the CPU, for every variant
at 2 blocks and two iteration counts.

The TPU kernel is a closure inside that tool's ``main``; the test compiles
the ``make_kernel`` part of the tool's source as it stands and calls it
through ``pl.pallas_call(..., interpret=True)``.

Tolerance: every variant but ``alu20`` does integer work on exactly
representable floats and must agree bit for bit. ``alu20`` is a chain of 10
multiply-adds per iteration, which XLA's CPU backend contracts into fused
multiply-adds and torch does not: each may round one ulp apart, so the bar
is 10 * iters * 2**-24 relative. (On the card the kernel is built without
contraction and is held to its plain version at 1e-6, chip_smoke.py.)"""

import functools
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from voxelrt_torch.ops import probe as tp

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = 2


@pytest.fixture(scope="module")
def make_kernel():
    with open(os.path.join(ROOT, "tools", "pallas_probe.py")) as fh:
        src = fh.read()
    body = src[src.index("    def make_kernel(variant):"):
               src.index("    x = jnp.asarray(np.random.rand")]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu)
    exec(textwrap.dedent(body), ns)
    return ns["make_kernel"]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((NB, 8, 128)) * 2048).astype(np.float32)
    tab = rng.integers(0, 100, (256, 128)).astype(np.int32)
    return x, tab


@pytest.mark.parametrize("iters", [3, 17])
@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_probe_plain_matches_pallas_interpret(make_kernel, variant, iters):
    x, tab = _inputs(iters)
    spec = pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0))
    tspec = pl.BlockSpec((256, 128), lambda b: (0, 0))
    want = np.asarray(pl.pallas_call(
        functools.partial(make_kernel(variant), iters=iters), grid=(NB,),
        in_specs=[spec, tspec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((NB, 8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(tab)))
    out, aux = tp.probe(torch.from_numpy(x), torch.from_numpy(tab), variant,
                        iters)
    assert out.shape == (NB, 8, 128) and aux.shape == (NB, 8, 128)
    if variant == "alu20":
        np.testing.assert_allclose(out.numpy(), want,
                                   rtol=10 * iters * 2.0 ** -24)
        assert not np.array_equal(out.numpy(), x + iters)
    else:
        np.testing.assert_array_equal(out.numpy(), want)


def test_probe_pieces_against_numpy():
    """The table index and the trailing-zero count, against numpy; aux holds
    the other carries and the lane's own table words."""
    x, tab = _inputs(5)
    w = np.arange(-5, 3000)
    got = tp.gather_1024(torch.from_numpy(tab.reshape(-1)[:1024].astype(
        np.int64)), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, tab.reshape(-1)[:1024][w & 1023])
    for i in range(1, 300):
        assert tp._ctz_steps(i) == (i & -i).bit_length() - 1
    assert tp._ctz_steps(0) == 31
    iters = 4
    _, aux = tp.probe(torch.from_numpy(x), torch.from_numpy(tab), "gather",
                      iters)
    idx = x.astype(np.int64) & 1023
    lane = sum(tab.reshape(-1)[:1024][(idx + i) & 1023] for i in range(iters))
    rest = sum((x + np.float32(k)) + np.float32(iters) for k in range(1, 8))
    np.testing.assert_allclose(aux.numpy(), rest + lane, rtol=1e-6)
    with pytest.raises(ValueError):
        tp.probe(torch.from_numpy(x), torch.from_numpy(tab), "nope", 1)


def test_cuda_probe_arguments():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import cuda_probe

    a = cuda_probe.parse_args([])
    assert a.variants == list(tp.VARIANTS) and a.iters == [512, 4096]
    assert a.blocks == 512 and a.x_scale == 1.0
    a = cuda_probe.parse_args(["--variants", "base", "fetch", "--iters", "8",
                               "16", "--blocks", "4", "--json"])
    assert a.variants == ["base", "fetch"] and a.iters == [8, 16] and a.json
    for bad in (["--iters", "16", "8"], ["--variants", "nope"],
                ["--blocks", "0"]):
        with pytest.raises(SystemExit):
            cuda_probe.parse_args(bad)
    x, tab = cuda_probe.probe_inputs(3, 1, "cpu", x_scale=1024.0)
    assert x.shape == (3, 8, 128) and tab.shape == (256, 128)
    assert 0 <= float(x.min()) and 512 < float(x.max()) < 1024


def test_cuda_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import cuda_probe

    assert cuda_probe.main(["--variants", "base"]) == 1
    with pytest.raises(RuntimeError):
        cuda_probe.run_probe(["base"])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_probe_kernel_matches_plain_on_card(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: P is a CUDA kernel")
    x, tab = _inputs(9)
    x, tab = torch.from_numpy(x).cuda(), torch.from_numpy(tab).cuda()
    for iters in (3, 64):
        ko, ka = tp.probe(x, tab, variant, iters)
        po, pa = tp.probe_plain(x, tab, variant, iters)
        torch.testing.assert_close(ko, po, rtol=1e-6, atol=0)
        torch.testing.assert_close(ka, pa, rtol=1e-6, atol=0)
