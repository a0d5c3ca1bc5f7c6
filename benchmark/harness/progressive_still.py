"""The runner of traffic of kind ``progressive_still``: the program renders
progressive stills of one scene, as a user who waits for converged images
does.

Set-up: the CUDA context, the port's kernels built or loaded, the scene
built by ``voxelrt_torch.app.examples.build_example`` with the
configuration's render settings and ``prepare_data``, then a warm-up of the
cell's own shapes: ``WARMUP_LAUNCHES`` launch, the image fetch, the
gather of the checked pixels and the history reset. The window drives
``pipeline.accumulate_n`` in chunks of ``chunk_spp`` samples (chunk keyed
``fold_in(key, 1 + samples done)``), dispatched ahead, synchronised only at
chunk ends; every ``reset_spp`` samples the still is finished (the image
fetched) and a new one starts from an empty history. The window closes at
the first chunk end after ``--seconds``.

The traced run then profiles one chunk (``trace.traced_chunk``); its
samples belong to the still being rendered, as all samples do.

For the comparison the runner keeps, on the device and without a
synchronise, the HDR colour and the tonemapped value of the pixels drawn
from the seed at the end of every still and of the last, unfinished one,
with the chunks that went into it; ``judge`` (``check.judge``) holds them
to the plain reference.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import trace
from benchmark.harness.check import judge

WARMUP_LAUNCHES = 1  # one launch of the cell's shape warms all it uses

__all__ = ["Run", "judge", "choose_pixels"]


class Run:
    def __init__(self, cell, seed, device):
        import torch

        self.torch = torch
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.traffic = cell["traffic"]
        self.k = int(self.traffic["samples_per_launch"])
        self.chunk_spp = int(self.traffic["chunk_spp"])
        self.reset_spp = int(self.traffic["reset_spp"])
        if self.chunk_spp % self.k or self.reset_spp % self.chunk_spp:
            raise ValueError("a chunk must be whole launches and a still "
                             "whole chunks")
        self.pixels_np = choose_pixels(seed, self.traffic["image_res"],
                                       cell["check"]["pixels"])
        self.done = 0  # samples rendered in the measured part of the run
        self.still_spp = 0
        self.stills = [[]]  # per still: the (chunk key data, launches) list
        self.captures = []  # per finished still: (hdr, ldr) of the pixels

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def clock(self):
        self.sync()
        return time.perf_counter()

    # --- set-up ---------------------------------------------------------

    def setup(self):
        """Everything before the window; returns its parts in seconds."""
        torch = self.torch
        parts = {}
        t = time.perf_counter()
        if self.cuda:
            # the CUDA context starts here: the first synchronise needs it
            torch.zeros(1, device=self.device)
            from voxelrt_torch.ops import _cuda

            t1 = self.clock()
            parts["cuda_init_s"] = t1 - t
            _cuda.build_all()
            for name in _cuda.SOURCES:
                _cuda.lib(name)
            t2 = self.clock()
            parts["kernels_s"] = t2 - t1
            t = t2
        from voxelrt_torch.app.examples import build_example
        from voxelrt_torch.ops import prng
        from voxelrt_torch.render import pipeline

        self.prng, self.pipeline = prng, pipeline
        cfg = self.cell["config"]
        scene = build_example(cfg["example"], self.device,
                              tuple(self.traffic["image_res"]),
                              samples_per_launch=self.k,
                              **cfg["render_config"])
        r = scene.renderer
        r.prepare_data()
        t1 = self.clock()
        parts["prepare_s"] = t1 - t
        self.renderer = r
        self.key = prng.key(self.seed)
        self.params = r._params(max_accum_frames=999999999.0)
        self.pixels = torch.as_tensor(self.pixels_np, dtype=torch.int64,
                                      device=self.device)
        # the warm-up: this cell's launch, image fetch, gather and reset
        state = r.state
        wkey = prng.fold_in(self.key, 0)
        wf = pipeline.wavefront_constants(r.cfg, 1.0, self.device)
        for i in range(WARMUP_LAUNCHES):
            state = pipeline.accumulate(r.cfg, r.scene_data, self.params,
                                        state, prng.fold_in(wkey, i), False,
                                        1.0, wf=wf)
        self._gather(state)
        self.state = pipeline.reset_framebuffer(state)
        del state
        t2 = self.clock()
        parts["warmup_s"] = t2 - t1
        if self.cuda:
            parts["setup_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        return parts

    # --- the measured part -------------------------------------------------

    def _gather(self, state):
        r = self.renderer
        img = self.pipeline.fetch_image(r.cfg, state, r._exposure)
        return (state.color.reshape(-1, 3)[self.pixels],
                img.reshape(-1, 3)[self.pixels])

    def _chunk_done(self, key_data, n_launches):
        self.stills[-1].append((key_data, n_launches))
        self.done += self.chunk_spp
        self.still_spp += self.chunk_spp
        if self.still_spp >= self.reset_spp:
            # the still is finished: its image is fetched, a new one starts
            self.captures.append(self._gather(self.state))
            self.state = self.pipeline.reset_framebuffer(self.state)
            self.stills.append([])
            self.still_spp = 0

    def run_chunk(self):
        """One chunk through ``accumulate_n``, enqueued without a
        synchronise."""
        r = self.renderer
        key_data = 1 + self.done
        self.state = self.pipeline.accumulate_n(
            r.cfg, r.scene_data, self.params, self.state,
            self.prng.fold_in(self.key, key_data), False, 1.0,
            self.chunk_spp)
        self._chunk_done(key_data, self.chunk_spp // self.k)

    def window(self, seconds):
        """Chunks until the first chunk end after ``seconds``; returns the
        window's samples, seconds, peak memory and the chunk end times."""
        torch = self.torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        done0 = self.done
        t0 = self.clock()
        ends = []
        while True:
            self.run_chunk()
            t = self.clock()
            ends.append(t - t0)
            if t - t0 >= seconds:
                break
        peak = (torch.cuda.max_memory_allocated(self.device) if self.cuda
                else None)
        return dict(spp=self.done - done0, seconds=t - t0, peak_bytes=peak,
                    chunk_ends_s=ends)

    def traced(self, root):
        """One chunk under the profiler: the trace record of
        ``trace.traced_chunk``."""
        return trace.traced_chunk(self, root)

    def close(self):
        """The unfinished still's pixels, then every capture on the host,
        the program's state dropped. Returns what ``judge`` reads:
        ``pixels``, the checked flat pixel ids, and ``stills``, a list of
        (chunks, hdr (P, 3), ldr (P, 3)) a still; ``chunks`` lists each
        chunk's key data (it is keyed ``fold_in(key, key data)``) and
        launches."""
        stills = self.stills
        caps = list(self.captures)
        if stills[-1]:
            caps.append(self._gather(self.state))
        else:
            stills = stills[:-1]
        self.sync()
        out = [(chunks, h.float().cpu(), l.float().cpu())
               for chunks, (h, l) in zip(stills, caps)]
        del self.state, self.renderer, self.params, self.pixels
        self.captures = []
        if self.cuda:
            self.torch.cuda.empty_cache()
        return dict(pixels=self.pixels_np, stills=out)


def choose_pixels(seed, image_res, n):
    """``n`` distinct flat pixel ids (x * H + y), drawn from the seed."""
    w, h = image_res
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF)
    n = min(int(n), w * h)
    return np.sort(rng.choice(w * h, size=n, replace=False))
