"""The benchmark's own tracing: spans around its calls into the program's
layers, the ring's transform entries wrapped for the roofline readers, a
count of dispatched aten ops, and the reduction of a torch.profiler trace
to busy time, kernel families and idle gaps.

Off (``Trace(False)``) every hook is a no-op, so an untraced run times the
program alone.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

import torch

#: the ring's transform entries the roofline readers count
NTT_ENTRIES = ("ntt", "intt", "ntt_single", "intt_single")
#: the bootstrap stage that starts at each ``on_stage`` mark
STAGE_NEXT = {"pre": "c2s", "c2s im": "evalmod", "mod1 im": "s2c", "out": "end"}
#: entries of each list of the result's ``breakdown`` (ten at most)
TOP = 10


class Trace:
    def __init__(self, on: bool, cuda: bool = True):
        self.on = on
        self.cuda = cuda
        self.recording = False          # spans and transforms into the window's sums
        self._spans = defaultdict(list)
        self._ntt = []

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def span(self, name: str):
        """A layer span: CUDA events while the window records, a profiler
        label while a profile runs."""
        if not self.on:
            yield
            return
        e0 = self._event() if self.recording and self.cuda else None
        with torch.profiler.record_function("hebench." + name):
            yield
        if e0 is not None:
            self._spans[name].append((e0, self._event()))

    @contextlib.contextmanager
    def stages(self):
        """The bootstrap's on_stage hook: a profiler label for the stage
        under way, and while the window records CUDA events at each stage's
        end, folded into the spans "c2s", "evalmod" and "s2c"."""
        if not self.on:
            yield None
            return
        events = self.recording and self.cuda
        marks = {"start": self._event()} if events else {}
        label = [torch.profiler.record_function("hebench.pre")]
        label[0].__enter__()

        def on_stage(stage, _ct):
            if events:
                marks[stage] = self._event()
            if stage in STAGE_NEXT:
                label[0].__exit__(None, None, None)
                label[0] = torch.profiler.record_function("hebench." + STAGE_NEXT[stage])
                label[0].__enter__()

        try:
            yield on_stage
        finally:
            label[0].__exit__(None, None, None)
        for name, a, b in (("c2s", "pre", "c2s im"), ("evalmod", "c2s im", "mod1 im"),
                           ("s2c", "mod1 im", "out")):
            if a in marks and b in marks:
                self._spans[name].append((marks[a], marks[b]))

    def span_ms(self) -> dict[str, float]:
        """Total ms of each span over the recorded window."""
        if self.cuda:
            torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self._spans.items()}

    # -- transforms ----------------------------------------------------------

    @contextlib.contextmanager
    def transforms(self):
        """Wrap the ring's transform entries: each call's residues, its
        bytes (each residue read once and written once, 4 B below 2^32, 8 B
        otherwise) and, on the card, CUDA events around it."""
        from lattigo_tpu_torch.ring.ring import Ring

        if not self.on:
            yield
            return
        orig = {name: getattr(Ring, name) for name in NTT_ENTRIES}
        tr = self

        def wrap(fn, single: bool):
            def wrapped(ring, *args, **kw):
                x = args[1] if single else args[0]
                qmax = max(ring.moduli)
                if not tr.recording:
                    return fn(ring, *args, **kw)
                e0 = tr._event() if tr.cuda else None
                out = fn(ring, *args, **kw)
                width = 4 if qmax < (1 << 32) else 8
                tr._ntt.append((x.numel(), 2 * width * x.numel(),
                                e0, tr._event() if tr.cuda else None))
                return out
            return wrapped

        for name in NTT_ENTRIES:
            setattr(Ring, name, wrap(orig[name], name.endswith("single")))
        try:
            yield
        finally:
            for name, fn in orig.items():
                setattr(Ring, name, fn)

    def ntt_totals(self) -> dict:
        """The recorded transforms' calls, residues, bytes and measured
        device ms."""
        if self.cuda:
            torch.cuda.synchronize()
        out = dict(calls=0, residues=0, bytes=0, ms=0.0)
        for res, nbytes, e0, e1 in self._ntt:
            out["calls"] += 1
            out["residues"] += res
            out["bytes"] += nbytes
            if e0 is not None:
                out["ms"] += e0.elapsed_time(e1)
        return out


def count_ops(fn) -> int:
    """The aten ops torch dispatched while fn() ran."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = [0]

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n[0] += 1
            return func(*args, **(kwargs or {}))

    with Mode():
        fn()
    return n[0]


# -- the profiler's trace --------------------------------------------------------

def kernel_family(name: str) -> str:
    """A device kernel's family: its template's name, with the (up to two)
    functors or ops it was instantiated for where the name carries them."""
    head = re.split(r"[<(]", name, maxsplit=1)[0].replace("void ", "").strip()
    found = []
    for tok in re.findall(r"(\w+(?:Functor|_kernel_cuda|_kernel_impl|_kernel))\b",
                          name[len(head):]):
        if not tok.startswith("gpu_") and tok not in found:
            found.append(tok)
    base = head.split("::")[-1]
    return f"{base}[{'/'.join(found[:2])}]" if found else base


def _merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_profile(events, wall_s: float) -> dict:
    """busy_s (the union of device activity), the ``TOP`` kernel families
    by device seconds, and the ``TOP`` idle gaps grouped by what the host
    was doing: the benchmark span and the innermost host op running at the
    gap's middle. ``events``: (name, on_device, start_ns, end_ns)."""
    dev = [(s, e, n) for n, on_dev, s, e in events if on_dev and e > s]
    host = [(s, e, n) for n, on_dev, s, e in events if not on_dev and e > s]
    spans = sorted(h for h in host if h[2].startswith("hebench."))
    ops = sorted(h for h in host if not h[2].startswith("hebench."))
    fam = defaultdict(float)
    for s, e, n in dev:
        fam[kernel_family(n)] += (e - s) / 1e9
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(b - a for a, b in merged) / 1e9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])

    def innermost(rows, starts, mid, steps):
        """The latest-started row that contains mid, looking back at most
        ``steps`` rows."""
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(-1, j - steps), -1):
            if rows[k][1] >= mid:
                return rows[k][2]
        return None

    span_starts, op_starts = [s for s, _, _ in spans], [s for s, _, _ in ops]
    by = defaultdict(float)
    for a, b in gaps[:5000]:
        mid = (a + b) // 2
        span = innermost(spans, span_starts, mid, len(spans))
        op = innermost(ops, op_starts, mid, 64)
        label = span[len("hebench."):] if span else "-"
        by[f"{label}:{op or 'python'}"] += (b - a) / 1e9
    return {
        "busy_s": busy,
        "window_s": wall_s,
        "device_ops": [[k, v] for k, v in sorted(fam.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def profile(fn, cuda: bool = True, host: bool = True) -> dict:
    """Run fn() under torch.profiler and reduce its trace
    (:func:`reduce_profile`). With ``host`` false on the card, only device
    activity is recorded. Either way the profiler slows the host, and so a
    host-paced stretch (by about a third with device activity alone, by
    half with host activity too): its busy time holds, its wall does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    if cuda:
        torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith("hebench.") and ev.device_type() != DeviceType.CPU:
            continue                   # the spans' own ranges on the device's timeline
        events.append((name, ev.device_type() != DeviceType.CPU, ev.start_ns(), ev.end_ns()))
    return reduce_profile(events, wall_s)
