"""The program's tracer: spans at its layer boundaries, and a count of the
synchronizing CUDA calls made inside them.

    from lattigo_tpu_torch import trace
    trace.start(cuda=True)
    ...                       # calls into the program
    snap = trace.stop()

Off by default. Off, :func:`span` reads one module flag and returns a shared
no-op context: no allocation, no profiler label, no CUDA event.

On, each span records its name, its parent and root spans, host start and
end from ``time.time_ns()`` (the clock ``torch.profiler`` stamps its events
with), a ``torch.profiler.record_function("lattigo." + name)`` label, so
that a profile shows the span on the device's timeline, and on the card a
pair of CUDA events. On the card, :func:`start` also sets
``torch.cuda.set_sync_debug_mode("warn")`` and captures torch's warning for
each synchronizing call (a pageable host-to-device copy, ``.item()``, ...),
counting every one against the innermost open span.

:func:`stop` returns a snapshot: for each span name its ``count``,
``host_ms``, ``device_ms`` (None off the card), ``self_device_ms`` and
``self_host_ms`` (less the span's direct children), ``syncs``,
``by_parent`` (count, host and device ms by the parent's name, ``None`` for
a root) and ``roots`` (count by the root's name); and ``syncs``: the
``total``, and those ``outside`` any span.
"""

from __future__ import annotations

import time
import warnings

import torch

#: the start of torch's warning for a synchronizing CUDA call under sync
#: debug mode "warn" (``c10::cuda::warn_or_error_on_sync``)
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_on = False
_state: _State | None = None


class _Off:
    """The shared context :func:`span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _State:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.stack: list[_Span] = []
        self.closed: list[_Span] = []
        self.syncs = 0
        self.syncs_outside = 0
        self.sync_mode = None
        self.warnings = None


class _Span:
    __slots__ = ("name", "st", "parent", "root", "children", "syncs", "label",
                 "t0", "t1", "e0", "e1")

    def __init__(self, name: str, st: _State):
        self.name = name
        self.st = st

    def __enter__(self):
        st = self.st
        parent = st.stack[-1] if st.stack else None
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.children = []
        self.syncs = 0
        if parent is not None:
            parent.children.append(self)
        st.stack.append(self)
        self.label = torch.profiler.record_function("lattigo." + self.name)
        self.label.__enter__()
        self.e0 = self.e1 = None
        if st.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        st = self.st
        if st.cuda:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record()
        self.label.__exit__(*exc)
        st.stack.pop()
        st.closed.append(self)
        return False


def span(name: str):
    """A context manager timing one call of a layer (see the module's
    docstring); the shared no-op context while the tracer is off."""
    if not _on:
        return _OFF
    return _Span(name, _state)


def _capture(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while the tracer is on the card: counts
    torch's warning for a synchronizing call against the innermost open
    span, and shows every other warning as before."""
    st = _state
    if st is not None and str(message).startswith(SYNC_MESSAGE):
        st.syncs += 1
        if st.stack:
            st.stack[-1].syncs += 1
        else:
            st.syncs_outside += 1
        return
    _showwarning(message, category, filename, lineno, file, line)


_showwarning = warnings.showwarning


def start(cuda: bool) -> None:
    """Clear the tracer and turn it on; ``cuda``: the program runs on the
    card (CUDA events, and the synchronizing calls counted)."""
    global _on, _state, _showwarning
    if _on:
        stop()
    st = _State(cuda)
    if cuda:
        st.warnings = warnings.catch_warnings()
        st.warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        _showwarning = warnings.showwarning
        warnings.showwarning = _capture
        st.sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _state = st
    _on = True


def stop() -> dict:
    """Turn the tracer off, restore the sync debug mode and the warning
    filters, synchronize once and return the snapshot (an empty one if the
    tracer was off)."""
    global _on, _state
    st = _state
    _on, _state = False, None
    if st is None:
        return _snapshot(_State(False))
    if st.cuda:
        torch.cuda.set_sync_debug_mode(st.sync_mode)
        st.warnings.__exit__(None, None, None)
        torch.cuda.synchronize()
    return _snapshot(st)


def _snapshot(st: _State) -> dict:
    cuda = st.cuda
    dev = {id(s): s.e0.elapsed_time(s.e1) for s in st.closed} if cuda else {}
    closed = {id(s) for s in st.closed}
    spans: dict[str, dict] = {}
    for s in st.closed:
        a = spans.setdefault(s.name, dict(
            count=0, host_ms=0.0, device_ms=0.0 if cuda else None, self_host_ms=0.0,
            self_device_ms=0.0 if cuda else None, syncs=0, by_parent={}, roots={}))
        kids = [c for c in s.children if id(c) in closed]
        host = (s.t1 - s.t0) / 1e6
        bp = a["by_parent"].setdefault(s.parent.name if s.parent else None, dict(
            count=0, host_ms=0.0, device_ms=0.0 if cuda else None))
        a["count"] += 1
        bp["count"] += 1
        a["roots"][s.root.name] = a["roots"].get(s.root.name, 0) + 1
        a["host_ms"] += host
        bp["host_ms"] += host
        a["self_host_ms"] += host - sum((c.t1 - c.t0) / 1e6 for c in kids)
        a["syncs"] += s.syncs
        if cuda:
            d = dev[id(s)]
            a["device_ms"] += d
            bp["device_ms"] += d
            a["self_device_ms"] += d - sum(dev[id(c)] for c in kids)
    return {"cuda": cuda, "spans": spans,
            "syncs": {"total": st.syncs, "outside": st.syncs_outside}}
