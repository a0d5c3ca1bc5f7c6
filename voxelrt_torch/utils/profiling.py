"""Observability: structured per-frame stats + profiling hooks (the PyTorch
port of voxelrt/utils/profiling.py).

  * :class:`FrameStats` — per-frame structured records (spp, wall ms,
    rays/s estimate) emitted to stdout or CSV.
  * :func:`sync` — wait for the device to finish what was queued on it.
  * :func:`trace` — context manager wrapping a ``torch.profiler`` trace,
    plus wall-clock timing; the operator's view of the spans below.
  * :func:`span`, :func:`count` and :func:`recorded` — the program's own
    spans and counters, recorded exactly while a ``torch.profiler`` session
    is open (:func:`trace`'s, or a benchmark's traced chunk), and read back
    by host window.

A span records its name, its parent (the span open when it began), its
attributes, its host start and end on ``time.time_ns()`` (the clock of the
profiler's events) and, where CUDA is initialised, two timing events
recorded on the current stream at enter and at exit. On one in-order stream
the interval between them is the span's time on the stream: from the end of
the work queued before it to the end of its own last kernel, so sibling
spans tile the stream and a span's self time is its interval less its
children's. Each span also enters ``torch.profiler.record_function`` so
that a Chrome trace shows the stages as ranges. A counter's value is a
Python int or a tensor, kept by reference and summed only when read, so no
counter synchronises. Recording adds no kernel, copy, set or synchronise.
Outside a session :func:`span` returns one shared null context after a
single check and :func:`count` returns at once.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import os
import sys
import threading
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


# --- spans and counters ------------------------------------------------------

STORE_SIZE = 1 << 16  # records kept; the oldest are dropped beyond it
_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans and counters are recorded now: exactly while a
    ``torch.profiler`` session is open."""
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "parent", "t0", "t1", "ev", "rf",
                 "stream")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.stream = None  # ms between its events, once read

    def __enter__(self):
        rec = RECORDER
        stack = rec.stack()
        self.parent = stack[-1] if stack else None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev = rec.events() if torch.cuda.is_initialized() else None
        if self.ev is not None:
            self.ev[0].record()
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.ev is not None:
            self.ev[1].record()
        self.rf.__exit__(*exc)
        self.rf = None
        stack = RECORDER.stack()
        if stack and stack[-1] is self:
            stack.pop()
        RECORDER.keep(self)
        return False


class _Count:
    __slots__ = ("name", "attrs", "parent", "value", "t")

    def __init__(self, name, value, attrs, parent):
        self.name, self.value, self.attrs = name, value, attrs
        self.parent, self.t = parent, time.time_ns()


class Recorder:
    """The bounded store of spans and counters, the open spans of each
    thread and a pool of reused CUDA timing event pairs."""

    def __init__(self, size=STORE_SIZE):
        self.records = collections.deque()
        self.size = size
        self.dropped = 0  # records dropped to keep the store bounded
        self._pool = []
        self._local = threading.local()
        self._lock = threading.Lock()

    def stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def events(self):
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def keep(self, record):
        with self._lock:
            if len(self.records) >= self.size:
                old = self.records.popleft()
                self.dropped += 1
                if isinstance(old, _Span):
                    self._release(old)
            self.records.append(record)

    def _release(self, span):
        if span.ev is not None:
            self._pool.append(span.ev)
            span.ev = None

    def recorded(self, t0_ns, t1_ns):
        """The spans and counters whose host interval lies inside [t0_ns,
        t1_ns]; see :func:`recorded`."""
        with self._lock:
            records = list(self.records)
        spans = [r for r in records if isinstance(r, _Span)
                 and t0_ns <= r.t0 and r.t1 <= t1_ns]
        counts = [r for r in records if isinstance(r, _Count)
                  and t0_ns <= r.t <= t1_ns]
        kids = collections.defaultdict(list)
        for s in spans:
            if s.parent is not None:
                kids[id(s.parent)].append(s)

        def stream_ms(s):
            # read once; the span's events then go back to the pool
            if s.ev is not None:
                s.stream = s.ev[0].elapsed_time(s.ev[1])
                with self._lock:
                    self._release(s)
            return s.stream

        ms = {id(s): ((s.t1 - s.t0) / 1e6, stream_ms(s)) for s in spans}
        out = []
        for s in spans:
            host, stream = ms[id(s)]
            ch = [ms[id(c)] for c in kids[id(s)]]
            out.append(dict(
                name=s.name, id=id(s),
                parent=None if s.parent is None else id(s.parent),
                attrs=_inherited(s), t0_ns=s.t0, t1_ns=s.t1, host_ms=host,
                host_self_ms=host - sum(c[0] for c in ch),
                stream_ms=stream,
                stream_self_ms=None if stream is None
                else stream - sum(c[1] for c in ch)))
        values = _values([c.value for c in counts])
        rows = [dict(name=c.name, attrs=_inherited(c), value=v, t_ns=c.t,
                     span=None if c.parent is None else id(c.parent))
                for c, v in zip(counts, values)]
        totals = {}
        for r in rows:
            totals[r["name"]] = totals.get(r["name"], 0) + r["value"]
        return dict(spans=out, counts=rows, counters=totals,
                    dropped=self.dropped)


def _inherited(record):
    """A record's attributes with those of the spans open around it (the
    nearest wins)."""
    chain, p = [], record
    while p is not None:
        chain.append(p.attrs)
        p = p.parent
    attrs = {}
    for a in reversed(chain):
        attrs.update(a)
    return attrs


def _values(values):
    """Counter values as Python numbers: tensors summed, one copy to the
    host a device."""
    out = list(values)
    by_dev = collections.defaultdict(list)
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_dev[v.device].append(i)
    for idx in by_dev.values():
        sums = torch.stack([values[i].double().sum() for i in idx]).cpu()
        for i, v in zip(idx, sums.tolist()):
            out[i] = v if values[i].is_floating_point() else int(v)
    return out


RECORDER = Recorder()


def span(name, **attrs):
    """A context manager recording the span ``name`` while a profiler
    session is open; outside one, a shared null context. Name a span
    ``layer.stage``; no name begins with ``cu`` (a trace reader takes host
    events so named for CUDA runtime calls)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, attrs)


def count(name, value, **attrs):
    """Record the counter ``name``: ``value`` is a Python int or a tensor
    (kept by reference, summed when read), with ``attrs`` and those of the
    spans open around it. Nothing is recorded outside a profiler session."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return
    stack = RECORDER.stack()
    RECORDER.keep(_Count(name, value, attrs, stack[-1] if stack else None))


def recorded(t0_ns, t1_ns):
    """The program's record inside the host window [t0_ns, t1_ns] (ns on
    ``time.time_ns()``), read after the caller's synchronise:

    * ``spans``: a dict a span: ``name``, ``id``, ``parent`` (its parent's
      id or None), ``attrs`` (its own and those of the spans around it),
      ``t0_ns``, ``t1_ns``, ``host_ms``, ``host_self_ms``, ``stream_ms``
      and ``stream_self_ms`` (None without CUDA timing events);
    * ``counts``: a dict a counter record, its ``value`` summed;
    * ``counters``: {name: sum over the window};
    * ``dropped``: records the bounded store has dropped so far."""
    return RECORDER.recorded(t0_ns, t1_ns)
