"""Observability: structured per-frame stats + profiling hooks (the PyTorch
port of voxelrt/utils/profiling.py).

  * :class:`FrameStats` — per-frame structured records (spp, wall ms,
    rays/s estimate) emitted to stdout or CSV.
  * :func:`sync` — wait for the device to finish what was queued on it.
  * :func:`trace` — context manager wrapping a ``torch.profiler`` trace,
    plus wall-clock timing.
"""

from __future__ import annotations

import contextlib
import csv
import os
import sys
import time

import torch


class FrameStats:
    def __init__(self, out=None, csv_path=None):
        self.out = out if out is not None else sys.stdout
        self.rows = []
        self.csv_path = csv_path
        self._csv = None
        self._fh = None
        if csv_path:
            self._fh = open(csv_path, "w", newline="")
            self._csv = csv.writer(self._fh)
            self._csv.writerow(["frame", "spp", "wall_ms", "mrays_per_s",
                                "moving"])
            self._fh.flush()

    def record(self, frame, spp, wall_ms, n_rays=None, quiet=False,
               moving=False):
        mrays = (n_rays / wall_ms / 1e3) if (n_rays and wall_ms) else 0.0
        row = dict(frame=frame, spp=spp, wall_ms=round(wall_ms, 3),
                   mrays_per_s=round(mrays, 2), moving=bool(moving))
        self.rows.append(row)
        if self._csv:
            self._csv.writerow([frame, spp, row["wall_ms"],
                                row["mrays_per_s"], int(row["moving"])])
            self._fh.flush()
        if not quiet:
            print(f"[frame {frame}] spp={spp} {wall_ms:.1f} ms "
                  f"({mrays:.1f} Mrays/s)", file=self.out)
        return row


def sync(device):
    """Wait until everything queued on ``device`` has run; a no-op on the
    CPU, where every operation has finished when its call returns."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(label="voxelrt_torch", log_dir=None):
    """torch.profiler trace (a Chrome trace written under ``log_dir``, when
    given) + wall clock; where there is a CUDA card the clock is read after
    the card has finished the traced work."""
    cuda = torch.cuda.is_available()
    t0 = time.perf_counter()
    if log_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            yield
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{label}.json"))
    else:
        yield
        if cuda:
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[trace] {label}: {dt * 1e3:.1f} ms", file=sys.stderr)
