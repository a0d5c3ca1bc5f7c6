"""Multi-device rendering over a grid of devices (the PyTorch port of
voxelrt/parallel/sharding.py).

One host process drives a ('dp', 'sp') grid of ``torch.device``s, as the
JAX package's single-controller ``Mesh`` does; ``torch.distributed`` is not
involved. A device may appear more than once in the grid, which is how one
card (or the CPU) runs the multi-device code paths.

  * **dp**: the image's pixel rows (the first, W axis of the buffers). The
    scene (occupancy pyramid, packed voxels, palette, sky) is replicated
    once per distinct device: it is far smaller than the per-pixel state.
  * **sp**: progressive samples. Each sp slice traces its own samples with
    decorrelated keys, and a mean over 'sp' merges them.

Two entry points:
  * :func:`sharded_accumulate_n`: the full progressive step (render +
    temporal pipeline). A still frame traces its wavefront's lanes split
    over every device of the grid (:func:`make_sharded_trace`); the GRIS
    pass and the temporal pipeline run on the state's device. A moving
    frame runs unsharded, as the JAX package runs it replicated.
  * :func:`parallel_render`: plain-average rendering over the grid, each
    (dp, sp) shard tracing its rows for spp/|sp| samples (no temporal
    filtering).

Where the port differs from the JAX package: there GSPMD partitions the
still frame's temporal pipeline over 'dp' as well; here it runs on one
device. Per-lane trace outputs, and so the images, are the same either way:
every random number is keyed on the global pixel id.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from voxelrt_torch.ops import v3
from voxelrt_torch.ops.prng import fold_in
from voxelrt_torch.render import pipeline
from voxelrt_torch.render.pathtracer import trace_sample

class Mesh:
    """A (dp, sp) grid of torch devices: ``devices[i][j]`` holds the i-th
    block of pixel rows and the j-th slice of samples."""

    def __init__(self, devices):
        self.devices = tuple(tuple(row) for row in devices)
        self.shape = {"dp": len(self.devices), "sp": len(self.devices[0])}
        self._replicas = {}  # type of tree -> (last tree, its copies)
        self._trace_fn = None

    @property
    def flat(self):
        """Every device of the grid, row by row."""
        return [d for row in self.devices for d in row]

    def distinct(self):
        return list(dict.fromkeys(self.flat))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, dp=None, sp=1) -> Mesh:
    """A ('dp', 'sp') grid over the given devices, or over every visible
    CUDA card (raising when there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass the devices explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n or n == 0:
        raise ValueError(f"make_mesh: dp={dp} x sp={sp} does not tile "
                         f"{n} devices")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def _on(device):
    return torch.cuda.device(device) if device.type == "cuda" else \
        contextlib.nullcontext()


def _to(tree, device):
    """``tree`` with every tensor on ``device`` (other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def replicate(tree, mesh: Mesh) -> dict:
    """{device: ``tree`` on that device} for each distinct device of the
    mesh. The mesh keeps the copies of the last tree of each type (the
    scene, the params), so a scene is copied to each card once per render,
    not once per launch."""
    hit = mesh._replicas.get(type(tree))
    if hit is not None and hit[0] is tree:
        return hit[1]
    copies = {d: _to(tree, d) for d in mesh.distinct()}
    mesh._replicas[type(tree)] = (tree, copies)
    return copies


def shard_state(state: pipeline.RenderState, mesh: Mesh):
    """The state's (W, H, ...) buffers split into 'dp' blocks of rows, block
    i on ``mesh.devices[i][0]``: a tuple of RenderStates. Kept for parity
    with the JAX package's API; no entry point of the port calls it, since
    the temporal pipeline runs on the state's device."""
    dp = mesh.shape["dp"]
    w = state.color.shape[0]
    if w % dp:
        raise ValueError(f"shard_state: {w} rows do not split over dp={dp}")
    rows = w // dp

    def part(x, i):
        if isinstance(x, torch.Tensor):
            return x[i * rows:(i + 1) * rows].to(mesh.devices[i][0])
        if isinstance(x, dict):
            return {k: part(v, i) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(part(v, i) for v in x)
        return x

    return tuple(
        dataclasses.replace(state, **{f.name: part(getattr(state, f.name), i)
                                      for f in dataclasses.fields(state)})
        for i in range(dp))


def _cat(parts, device):
    """Concatenate per-shard outputs (tensors, dicts, tuples of them) along
    the lanes, on ``device``."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(x, dict):
        return {k: _cat([p[k] for p in parts], device) for k in x}
    items = (_cat([p[i] for p in parts], device) for i in range(len(x)))
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def make_sharded_trace(mesh: Mesh):
    """A drop-in for ``render.pathtracer.trace_sample`` that splits the
    wavefront's lanes (with their sample keys and jitter) into contiguous
    chunks, one per device of the grid, traces every chunk on its device,
    all enqueued before any is gathered, and concatenates the outputs on
    the lanes' device. Per-lane outputs are those of the plain trace: the
    random numbers are keyed on global pixel ids, and the sorted route sorts
    within a chunk. When the lanes do not divide, the plain trace runs.
    Cached per mesh."""
    if mesh._trace_fn is not None:
        return mesh._trace_fn
    shards = mesh.flat

    def trace_fn(cfg, scene, params, u, v, sample_keys, jitter_u,
                 camera_is_moving=False, render_scale=1.0):
        n = u.shape[0]
        if n % len(shards):
            return trace_sample(cfg, scene, params, u, v, sample_keys,
                                jitter_u, camera_is_moving, render_scale)
        c = n // len(shards)
        scenes, ps = replicate(scene, mesh), replicate(params, mesh)

        def part(x, i, dev):
            if isinstance(x, torch.Tensor) and x.dim():
                return x[i * c:(i + 1) * c].to(dev)
            return _to(x, dev)

        inputs = [(dev, tuple(part(x, i, dev) for x in (u, v)),
                   tuple(part(x, i, dev) for x in sample_keys),
                   tuple(part(x, i, dev) for x in jitter_u))
                  for i, dev in enumerate(shards)]
        outs = []
        for dev, (su, sv), sk, sj in inputs:
            with _on(dev):
                outs.append(trace_sample(cfg, scenes[dev], ps[dev], su, sv,
                                         sk, sj, camera_is_moving,
                                         render_scale))
        return _cat(outs, u.device)

    mesh._trace_fn = trace_fn
    return trace_fn


def sharded_accumulate_n(cfg, scene, params, state, key, camera_is_moving,
                         render_scale, n_samples, mesh: Mesh):
    """``pipeline.accumulate_n`` with a still frame's trace split over the
    mesh. A moving frame runs unsharded: a moving frame is latency-bound
    (half resolution, one sample) and reprojects history from arbitrary
    rows, so the JAX package runs it replicated. ``scene``, ``params`` and
    ``state`` live on one device, where the GRIS pass and the temporal
    pipeline run."""
    trace_fn = None if camera_is_moving else make_sharded_trace(mesh)
    return pipeline.accumulate_n(cfg, scene, params, state, key,
                                 camera_is_moving, render_scale, n_samples,
                                 trace_fn=trace_fn)


def parallel_render(cfg, scene, params, key, spp, mesh: Mesh,
                    camera_is_moving=False, render_scale=1.0):
    """Plain-average render of ``spp`` samples over the ('dp', 'sp') mesh.

    Shard (i, j) traces the i-th block of pixel rows for spp/|sp| samples,
    sample s keyed by fold_in(fold_in(key, j), s); a mean over 'sp' merges
    the slices. Returns the (W, H, 3) HDR image (diffuse + specular) on the
    scene's device."""
    w, h = cfg.image_res
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if w % dp or spp % sp:
        raise ValueError(f"parallel_render: W={w} over dp={dp}, spp={spp} "
                         f"over sp={sp}")
    local_spp = spp // sp
    rows = w // dp
    home = scene.occ_words.device
    scenes, ps = replicate(scene, mesh), replicate(params, mesh)
    acc = {}
    for i in range(dp):
        for j in range(sp):
            dev = mesh.devices[i][j]
            with _on(dev):
                u = torch.arange(i * rows, (i + 1) * rows, dtype=torch.float32,
                                 device=dev)[:, None].expand(rows, h).reshape(-1)
                v = torch.arange(h, dtype=torch.float32,
                                 device=dev)[None, :].expand(rows, h).reshape(-1)
                a = v3.zeros(u.shape[0], dev)
                for s in range(local_spp):
                    k = fold_in(fold_in(key, j), s)
                    skeys, jit = pipeline.sample_keys_of(k, 1)
                    ju = jit.to(dev)
                    out = trace_sample(cfg, scenes[dev], ps[dev], u, v,
                                       skeys[0], (ju[0, 0], ju[0, 1]),
                                       camera_is_moving, render_scale)
                    a = a + out["diffuse"] + out["specular"]
                acc[i, j] = a / local_spp
    blocks = []
    for i in range(dp):
        m = _to(acc[i, 0], home)
        for j in range(1, sp):
            m = m + _to(acc[i, j], home)
        blocks.append(v3.stack(m / sp).reshape(rows, h, 3))
    return torch.cat(blocks)
