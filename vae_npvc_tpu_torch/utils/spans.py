"""Spans: named host intervals of the port's phases, and CUDA-event times
of chosen launches, recorded in memory for a traced run.

The recorder is off until ``enable(True)``. Off, :func:`span` and
:func:`device_span` return one shared no-op context manager, so a phase
pays one attribute check and an empty ``with``.

On, each :func:`span` appends ``Span(name, id, parent, thread, start_ns,
end_ns)`` to a bounded buffer of its thread. Times are
``time.time_ns()``, the clock of ``torch.profiler``'s host events (and of
the device events CUPTI places beside them), so a span lies over the
profiler's runtime calls and kernels in one timeline. ``thread`` is the
native thread id, as the profiler's Chrome trace names threads. The parent
is the innermost open span of the same thread; a thread with none open
(autograd's device thread) takes the innermost open span of the thread
that called :func:`enable`. A full buffer counts what it drops and does
not grow.

:func:`device_span` (on only with ``enable(True, device=True)``, and only
for a CUDA tensor) records a pair of timing events on the current stream
around its block, from a pool of reused events, and keeps a small device
tensor to be read later; it never synchronizes. While the stream is being
captured into a CUDA graph it records nothing. :func:`drain` returns the
host spans, each device span's ``(name, ms, value)`` (the kept tensor's
sum) and the drop count, and empties the buffers. Its caller synchronizes
the device first.

What reads which span: ``PERF.md`` §3.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

# spans (and device spans) one thread keeps between drains
CAPACITY = 1 << 17

now = time.time_ns


class Span(NamedTuple):
    name: str
    id: int
    parent: int           # 0: none
    thread: int           # native thread id
    start_ns: int
    end_ns: int


class _Off:
    """The recorder's context manager while it is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


OFF = _Off()


class _Thread:
    """One thread's open spans and buffers."""

    __slots__ = ("thread", "tid", "stack", "spans", "device", "drops")

    def __init__(self):
        self.thread = threading.current_thread()
        self.tid = threading.get_native_id()
        self.stack = []
        self.spans = []
        self.device = []
        self.drops = 0


class _Open:
    __slots__ = ("rec", "name", "st", "sid", "parent", "start")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        st = self.st = self.rec._state()
        stack = st.stack
        self.parent = stack[-1] if stack else self.rec._root_parent()
        self.sid = next(self.rec._ids)
        stack.append(self.sid)
        self.start = now()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = now()
        st = self.st
        st.stack.pop()
        if len(st.spans) < self.rec.capacity:
            st.spans.append((self.name, self.sid, self.parent, st.tid,
                             self.start, end))
        else:
            st.drops += 1
        return False


class _DeviceOpen:
    __slots__ = ("rec", "name", "keep", "device", "stream", "start")

    def __init__(self, rec, name, keep, device):
        self.rec, self.name, self.keep, self.device = rec, name, keep, device

    def __enter__(self):
        self.stream = torch.cuda.current_stream(self.device)
        self.start = self.rec._event(self.device)
        self.start.record(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self.rec._event(self.device)
        end.record(self.stream)
        st = self.rec._state()
        if len(st.device) < self.rec.capacity:
            st.device.append((self.name, self.device, self.start, end,
                              self.keep))
        else:
            st.drops += 1
        return False


class Recorder:
    """Spans of every thread of the process, off until :meth:`enable`."""

    def __init__(self, capacity=CAPACITY):
        self.capacity = int(capacity)
        self.on = False
        self.device_on = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self._threads = []
        self._root = None
        self._ids = itertools.count(1)
        self._pool = {}           # device index -> idle timing events

    def enable(self, on=True, device=False):
        """Turn host spans on or off; ``device`` also turns the CUDA-event
        spans on. The calling thread becomes the one whose open span
        parents the spans of threads that have none open."""
        self.on = bool(on)
        self.device_on = bool(on and device)
        self._root = self._state() if on else None

    def span(self, name):
        """A context manager recording ``name`` over its block."""
        if not self.on:
            return OFF
        return _Open(self, name)

    def device_span(self, name, tensor):
        """A context manager recording CUDA events around its block on
        the current stream of ``tensor``'s device, keeping ``tensor`` (a
        small counter the block fills) to be summed at :meth:`drain`."""
        if not self.device_on or not tensor.is_cuda \
                or torch.cuda.is_current_stream_capturing():
            # a captured launch records no event: the graph's replays run
            # without the host
            return OFF
        return _DeviceOpen(self, name, tensor, tensor.device.index)

    def drain(self):
        """``{"spans": [Span], "device": [(name, ms, value)], "drops":
        n}`` of every thread since the last drain (spans by start), and
        the buffers emptied. The device must have finished the recorded
        work (the caller synchronizes)."""
        with self._lock:
            threads = list(self._threads)
            # a finished thread's buffers are drained once more, then gone
            self._threads = [t for t in threads if t.thread.is_alive()]
        host, dev, drops = [], [], 0
        for st in threads:
            spans, st.spans = st.spans, []
            device, st.device = st.device, []
            drops, st.drops = drops + st.drops, 0
            host.extend(Span(*s) for s in spans)
            dev.extend(device)
        out = []
        for name, device, start, end, keep in dev:
            out.append((name, start.elapsed_time(end), int(keep.sum())))
            self._pool.setdefault(device, []).extend((start, end))
        host.sort(key=lambda s: s.start_ns)
        return {"spans": host, "device": out, "drops": drops}

    # ------------------------------------------------------------ internal
    def _state(self):
        st = getattr(self._local, "st", None)
        if st is None:
            st = self._local.st = _Thread()
            with self._lock:
                self._threads.append(st)
        return st

    def _root_parent(self):
        root = self._root
        try:
            return root.stack[-1] if root is not None else 0
        except IndexError:      # the root's last span closed meanwhile
            return 0

    def _event(self, device):
        pool = self._pool.get(device)
        if pool:
            return pool.pop()
        return torch.cuda.Event(enable_timing=True)


# the process's recorder, which the port's phases record into
recorder = Recorder()
enable = recorder.enable
span = recorder.span
device_span = recorder.device_span
drain = recorder.drain


def chrome_events(spans, base_ns=0, pid=0):
    """Chrome trace events (``ph: "X"``, microseconds after ``base_ns``,
    the trace's ``baseTimeNanoseconds``) of host spans, one per span on
    its thread of process ``pid``."""
    out = []
    return [{"ph": "X", "cat": "span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent}} for s in spans]
