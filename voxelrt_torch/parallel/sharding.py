"""Multi-device rendering over a grid of devices (the PyTorch port of
voxelrt/parallel/sharding.py).

One host process drives a ('dp', 'sp') grid of ``torch.device``s, as the
JAX package's single-controller ``Mesh`` does; ``torch.distributed`` is not
involved. A device may appear more than once in the grid, which is how one
card (or the CPU) runs the multi-device code paths.

  * **dp**: the image's pixel rows (the first, W axis of the buffers). A
    still frame's state is partitioned (:func:`shard_state`): block i,
    W/dp rows, lives on ``devices[i][0]``. The scene (occupancy pyramid,
    packed voxels, palette, sky) and the params are replicated once per
    distinct device: they are far smaller than the per-pixel state.
  * **sp**: the lanes of a block's wavefront, split over the block's row
    of the grid (:func:`make_sharded_trace`); in :func:`parallel_render`,
    progressive samples, merged by a mean over 'sp'.

Two entry points:
  * :func:`sharded_accumulate_n`: the full progressive step. A still frame
    runs per block: the block's wavefront (its active pixels, in the
    image's order, with the image's pixel ids) is traced over its row of
    the grid and gathered onto ``devices[i][0]``; the GRIS pass and the
    temporal pipeline then run on the block, with halo rows of the other
    blocks' post-trace buffers (ceil(restir_radius) rows each side for the
    GRIS taps, 1 before and 2 after for the prepass's 4×4 window) copied
    device to device without waiting for the host (:func:`rows`). It
    returns the partitioned state, a tuple of per-block RenderStates;
    :func:`gather_state` makes one RenderState of it. A moving frame runs
    unpartitioned on the scene's device, as the JAX package runs it
    replicated: the state is gathered there at the still→moving transition
    and split again at moving→still.
  * :func:`parallel_render`: plain-average rendering over the grid, each
    (dp, sp) shard tracing its rows for spp/|sp| samples (no temporal
    filtering).

Every random number is keyed on the global pixel id, and the GRIS pass's
threefry counters are its pixels' (``prng.uniform``'s offset), so a block
computes its pixels' values of the one-device frame bit for bit: the
gathered state is ``pipeline.accumulate_n``'s.
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
        self._trace_fns = {}  # row of the grid -> make_sharded_trace's

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
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
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


def _move(x, device):
    """``x`` on ``device``; a copy to a card does not wait for the host."""
    return x.to(device, non_blocking=device.type == "cuda")


def shard_state(state: pipeline.RenderState, mesh: Mesh):
    """The partitioned state: the state's (W, H, ...) buffers split into
    'dp' blocks of W/dp rows, block i on ``mesh.devices[i][0]``, as a tuple
    of RenderStates (each with the state's ``spp`` and ``frame``)."""
    dp = mesh.shape["dp"]
    w = state.color.shape[0]
    if w % dp:
        raise ValueError(f"shard_state: {w} rows do not split over dp={dp}")
    rows = w // dp

    def part(x, i):
        if isinstance(x, torch.Tensor):
            return _move(x[i * rows:(i + 1) * rows], mesh.devices[i][0])
        if isinstance(x, dict):
            return {k: part(v, i) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(part(v, i) for v in x)
        return x

    return tuple(
        dataclasses.replace(state, **{f.name: part(getattr(state, f.name), i)
                                      for f in dataclasses.fields(state)})
        for i in range(dp))


def block_bounds(state):
    """The image rows [lo, hi) of each block of a partitioned state."""
    bounds, lo = [], 0
    for block in state:
        hi = lo + block.color.shape[0]
        bounds.append((lo, hi))
        lo = hi
    return bounds


def rows(parts, bounds, get, lo, hi, device):
    """The image's rows [lo, hi) of the buffer that ``get`` takes from each
    block's part (a block's RenderState, or its post-trace buffers), the
    blocks holding the rows ``bounds``, fetched from every block that holds
    some of them onto ``device``."""
    pieces = []
    for part, (a, b) in zip(parts, bounds):
        if max(lo, a) < min(hi, b):
            pieces.append(_move(get(part)[max(lo, a) - a:min(hi, b) - a],
                                device))
    if not pieces:
        x = get(parts[0])
        return x.new_empty((0,) + tuple(x.shape[1:]), device=device)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def gather_state(state, device=None) -> pipeline.RenderState:
    """One RenderState of a partitioned state, on ``device`` (default: the
    first block's); a RenderState is returned as it is, or moved there."""
    if not isinstance(state, tuple):
        return state if device is None else _to(state, device)
    device = torch.device(device) if device is not None else \
        state[0].color.device
    bounds = block_bounds(state)
    w = bounds[-1][1]

    def cat(get):
        return rows(state, bounds, get, 0, w, device)

    fields = {}
    for f in dataclasses.fields(pipeline.RenderState):
        v = getattr(state[0], f.name)
        if isinstance(v, torch.Tensor):
            v = cat(lambda s, n=f.name: getattr(s, n))
        elif f.name == "reservoirs" and v is not None:
            v = tuple({k: cat(lambda s, i=i, k=k: s.reservoirs[i][k])
                       for k in slot} for i, slot in enumerate(v))
        fields[f.name] = v
    return pipeline.RenderState(**fields)


def _cat(parts, device):
    """Concatenate per-shard outputs (tensors, dicts, tuples of them) along
    the lanes, on ``device``."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat([_move(p, device) for p in parts])
    if isinstance(x, dict):
        return {k: _cat([p[k] for p in parts], device) for k in x}
    items = (_cat([p[i] for p in parts], device) for i in range(len(x)))
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def make_sharded_trace(mesh: Mesh, row: int):
    """A drop-in for ``render.pathtracer.trace_sample`` for block ``row``'s
    wavefront: it splits the lanes (with their sample keys and jitter) into
    contiguous chunks, one per device of ``mesh.devices[row]``, traces
    every chunk on its device with the replicas of the scene and params it
    is given, all enqueued before any is gathered, and concatenates the
    outputs on the lanes' device. Per-lane outputs are those of the plain
    trace: the random numbers are keyed on global pixel ids, and the sorted
    route unsorts what it sorts within a chunk. When the lanes do not
    divide, the lanes' device traces them all. Cached per mesh and row."""
    if row in mesh._trace_fns:
        return mesh._trace_fns[row]
    shards = mesh.devices[row]

    def trace_fn(cfg, scene, params, u, v, sample_keys, jitter_u,
                 camera_is_moving=False, render_scale=1.0):
        n = u.shape[0]
        devs = shards if n % len(shards) == 0 else (u.device,)
        c = n // len(devs)
        scenes, ps = replicate(scene, mesh), replicate(params, mesh)

        def part(x, i, dev):
            if isinstance(x, torch.Tensor) and x.dim():
                return _move(x[i * c:(i + 1) * c], dev)
            return _to(x, dev)

        inputs = [(dev, tuple(part(x, i, dev) for x in (u, v)),
                   tuple(part(x, i, dev) for x in sample_keys),
                   tuple(part(x, i, dev) for x in jitter_u))
                  for i, dev in enumerate(devs)]
        outs = []
        for dev, (su, sv), sk, sj in inputs:
            with _on(dev):
                outs.append(trace_sample(cfg, scenes[dev], ps[dev], su, sv,
                                         sk, sj, camera_is_moving,
                                         render_scale))
        return outs[0] if len(outs) == 1 else _cat(outs, u.device)

    mesh._trace_fns[row] = trace_fn
    return trace_fn


def sharded_accumulate_n(cfg, scene, params, state, key, camera_is_moving,
                         render_scale, n_samples, mesh: Mesh):
    """``pipeline.accumulate_n`` over the mesh. ``state``: a RenderState on
    one device or a partitioned state. Still frames run partitioned over
    'dp' (the module's docstring) and return the partitioned state; a
    moving frame runs unpartitioned on the scene's device, where a
    partitioned state is gathered first, and returns a RenderState there:
    a moving frame is latency-bound (half resolution, one sample) and
    reprojects history from arbitrary rows, so the JAX package runs it
    replicated. ``scene`` and ``params`` live on one device; every other
    device of the mesh gets its replica once per render."""
    if camera_is_moving:
        return pipeline.accumulate_n(
            cfg, scene, params, gather_state(state, scene.occ_words.device),
            key, True, render_scale, n_samples)
    dp = mesh.shape["dp"]
    if not isinstance(state, tuple):
        state = shard_state(state, mesh)
    devs = [mesh.devices[i][0] for i in range(dp)]
    if [b.color.device for b in state] != devs:
        raise ValueError("sharded_accumulate_n: the partitioned state's "
                         "blocks are not on the mesh's 'dp' devices")
    bounds = block_bounds(state)
    scenes, ps = replicate(scene, mesh), replicate(params, mesh)
    wfs = [pipeline.wavefront_constants(cfg, render_scale, d, rows=b)
           for d, b in zip(devs, bounds)]
    k = max(1, cfg.samples_per_launch)
    pin = any(d.type == "cuda" for d in devs)
    for j in range(-(-n_samples // k)):
        lkey = fold_in(key, j)
        keys = pipeline.launch_keys(lkey, k, pin)
        # every block's trace is enqueued before any block resolves
        frames = []
        for i, dev in enumerate(devs):
            with _on(dev):
                frames.append(pipeline.trace_frame(
                    cfg, scene, params, state[i], keys, False, render_scale,
                    wfs[i], make_sharded_trace(mesh, i), lo=bounds[i][0]))

        def halo_on(dev):
            return lambda get, a, b: rows(frames, bounds, get, a, b, dev)

        blocks = []
        for i, dev in enumerate(devs):
            with _on(dev):
                blocks.append(pipeline.resolve_frame(
                    cfg, scenes[dev], ps[dev], state[i], frames[i], lkey,
                    False, render_scale, lo=bounds[i][0],
                    halo=halo_on(dev)))
        state = tuple(blocks)
        del frames, blocks
    return state


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
