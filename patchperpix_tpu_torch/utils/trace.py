"""Spans and counters of the port, on the profiler's clock.

``span(name)`` times a block of work, ``count(name, n)`` adds to a
counter.  Both record only while a ``torch.profiler`` session is active
in the thread that drives the work; otherwise each costs one check and
records nothing.  While recording, a span

- opens a ``torch.profiler.record_function`` range of its name, so that
  it lies on the profiler's timeline beside the device's kernels and a
  trace shows which span each idle gap of the device falls under;
- takes its host interval from ``time.perf_counter``;
- given a CUDA ``device``, records a pair of timing events on that
  device's current stream (recording them never synchronises).  Device
  times are put on the host clock through one reference event per
  device, synchronised once when recording starts.

Each record holds its name, the enclosing span's name (``parent``), the
step id that an enclosing ``span(..., step=i)`` set, and its host and
device intervals.  Totals are kept by name and only the last ``KEEP``
records, so that a long run under a profiler stays bounded.

The profiler's state is per thread: a thread started before the
profiler (a prefetch thread) never sees it.  The first thread that
records under a profiler owns the session; other threads record while
it is open, and what they record is clipped to the host interval of the
owner's spans and counts, so that work done after the owner's last span
(a queue refilling once the loop has stopped) is not counted.  A span
that another thread opened before the session began is not recorded.
The session closes when its owner records, or reads ``summary()``, with
no profiler running; the next profiler session starts from empty totals.

``Stages`` times the consecutive stages of one call as spans and, when
the caller asks for them, returns each stage's seconds after one wait
at the end of the call.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

KEEP = 1024          # records kept for reading
OUTSIDE_CAP = 4096   # other threads' records waiting for the owner's cover

_profiling = torch._C._autograd._profiler_enabled
_local = threading.local()       # .stack: this thread's open records
_current = None                  # the latest session (open or closed)


class _Record:
    __slots__ = ("name", "parent", "step", "t0", "t1", "device", "ev0",
                 "ev1", "d0", "d1")

    def __init__(self, name, parent, step, device):
        self.name, self.parent, self.step = name, parent, step
        self.device = device
        self.t0 = self.t1 = self.d0 = self.d1 = None
        self.ev0 = self.ev1 = None

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "step": self.step,
                "host": (self.t0, self.t1),
                "device": None if self.d0 is None else (self.d0, self.d1)}


class _Session:
    """What one profiler session recorded."""

    def __init__(self):
        self.owner = threading.get_ident()
        self.lock = threading.Lock()
        self.closed = False
        self.step = None
        self.first = self.last = time.perf_counter()
        self.totals: dict = {}   # name -> [count, host_s, device_s, gap_s,
        #                           end of the latest]
        self.counts: dict = {}
        self.records = collections.deque(maxlen=KEEP)
        self.unresolved = collections.deque()  # the owner's, events pending
        self.outside = collections.deque()     # other threads' records and
        #                                        (time, name, n) counts
        self.refs: dict = {}     # device -> (event, its host time)

    def ref(self, device):
        if device not in self.refs:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            ev.synchronize()
            self.refs[device] = (ev, time.perf_counter())
        return self.refs[device]

    def add(self, rec: _Record, mine: bool):
        with self.lock:
            if not mine:
                self.outside.append(rec)
                if len(self.outside) > OUTSIDE_CAP:
                    self._fold_outside(self.outside.popleft(), self.totals,
                                       self.counts, keep=True)
                return
            self.last = max(self.last, rec.t1)
            if rec.ev0 is not None:
                self.unresolved.append(rec)
                self._resolve()
            else:
                self._fold(rec, self.totals, keep=True)
            self._cover()

    def add_count(self, name: str, n, mine: bool):
        with self.lock:
            if mine:
                self.counts[name] = self.counts.get(name, 0) + n
            else:
                self.outside.append((time.perf_counter(), name, n))

    def _resolve(self):
        """Fold the owner's records whose events the device has passed,
        oldest first."""
        while self.unresolved and self.unresolved[0].ev1.query():
            rec = self.unresolved.popleft()
            ref, t_ref = self.refs[rec.device]
            rec.d0 = t_ref + ref.elapsed_time(rec.ev0) * 1e-3
            rec.d1 = rec.d0 + rec.ev0.elapsed_time(rec.ev1) * 1e-3
            rec.ev0 = rec.ev1 = None
            self._fold(rec, self.totals, keep=True)

    def _cover(self):
        """Fold the other threads' items that the owner's interval now
        covers."""
        while self.outside and _end(self.outside[0]) <= self.last:
            self._fold_outside(self.outside.popleft(), self.totals,
                               self.counts, keep=True)

    def _fold_outside(self, item, totals, counts, keep=False):
        if isinstance(item, tuple):
            _, name, n = item
            counts[name] = counts.get(name, 0) + n
        else:
            self._fold(item, totals, keep)

    def _fold(self, rec: _Record, totals: dict, keep: bool):
        tot = totals.setdefault(rec.name, [0, 0.0, None, 0.0, None])
        tot[0] += 1
        tot[1] += rec.t1 - rec.t0
        start, end = rec.t0, rec.t1
        if rec.d0 is not None:
            tot[2] = (tot[2] or 0.0) + rec.d1 - rec.d0
            start, end = rec.d0, rec.d1
        if tot[4] is not None:
            tot[3] += max(start - tot[4], 0.0)
        tot[4] = end
        if keep:
            self.records.append(rec)

    def summary(self) -> dict:
        with self.lock:
            last = {}
            for rec in self.unresolved:
                last[rec.device] = rec.ev1
            for ev in last.values():
                ev.synchronize()
            self._resolve()
            self._cover()
            totals = {k: list(v) for k, v in self.totals.items()}
            counts = dict(self.counts)
            for item in self.outside:   # clipped to the owner's interval
                if isinstance(item, tuple):
                    if self.first <= item[0] <= self.last:
                        self._fold_outside(item, totals, counts)
                    continue
                t0, t1 = max(item.t0, self.first), min(item.t1, self.last)
                if t1 > t0:
                    clipped = _Record(item.name, item.parent, item.step,
                                      None)
                    clipped.t0, clipped.t1 = t0, t1
                    self._fold(clipped, totals, keep=False)
            spans = {name: {"count": c, "host_s": h, "device_s": d,
                            "gap_s": g}
                     for name, (c, h, d, g, _) in totals.items()}
            return {"spans": spans, "counts": counts,
                    "host_interval": (self.first, self.last)}


def _end(item) -> float:
    return item[0] if isinstance(item, tuple) else item.t1


def _active():
    """The session this thread records into, or None."""
    global _current
    ses = _current
    if _profiling():
        if ses is None or ses.closed:
            ses = _current = _Session()
        return ses
    if ses is None or ses.closed:
        return None
    if ses.owner == threading.get_ident():
        ses.closed = True
        return None
    return ses


def _cuda(device):
    """``device`` as an indexed CUDA device, or None for any other."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class span:
    """``with span(name, device=None, step=None):`` records the block
    while a profiler session is active (module docstring).  ``device``:
    a CUDA device whose current stream the block's device work runs on,
    to time that work too; ``step``: the step id this span and the spans
    inside it carry."""

    __slots__ = ("name", "device", "step", "ses", "rec", "rf", "prev")

    def __init__(self, name: str, device=None, step=None):
        self.name, self.device, self.step = name, device, step
        self.ses = None

    def __enter__(self):
        ses = _active()
        if ses is None:
            return self
        self.ses = ses
        st = _stack()
        dev = _cuda(self.device)
        if self.step is not None:
            self.prev, ses.step = ses.step, self.step
        rec = self.rec = _Record(self.name, st[-1].name if st else None,
                                 ses.step, dev)
        if dev is not None:
            ses.ref(dev)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if dev is not None:
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record(torch.cuda.current_stream(dev))
        rec.t0 = time.perf_counter()
        st.append(rec)
        return self

    def __exit__(self, *exc):
        ses = self.ses
        if ses is None:
            return False
        self.ses = None
        rec = self.rec
        rec.t1 = time.perf_counter()
        if rec.device is not None:
            rec.ev1 = torch.cuda.Event(enable_timing=True)
            rec.ev1.record(torch.cuda.current_stream(rec.device))
        self.rf.__exit__(*exc)
        _stack().pop()
        if self.step is not None:
            ses.step = self.prev
        ses.add(rec, ses.owner == threading.get_ident())
        return False


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` while recording."""
    ses = _active()
    if ses is not None:
        ses.add_count(name, n, ses.owner == threading.get_ident())


def summary() -> dict:
    """What the latest profiler session recorded, after one synchronise
    for the events still pending: ``{"spans": {name: {"count", "host_s",
    "device_s", "gap_s"}}, "counts": {name: n}, "host_interval": (first,
    last)}``.  ``device_s`` is None for a span timed on the host only;
    ``gap_s`` is the time from the end of one span of a name to the start
    of the next, on the device's clock where the span has one."""
    ses = _current
    if ses is None:
        return {"spans": {}, "counts": {}, "host_interval": None}
    if not ses.closed and ses.owner == threading.get_ident() \
            and not _profiling():
        ses.closed = True
    return ses.summary()


def records() -> list:
    """The latest session's last ``KEEP`` resolved records, as dicts:
    name, parent, step, host (start, end), device (start, end) or None."""
    ses = _current
    if ses is None:
        return []
    with ses.lock:
        return [r.as_dict() for r in ses.records]


class Stages:
    """``with Stages(prefix, device, out) as st: st.next("a"); ...;
    st.next("b"); ...``: each stage is a ``span`` named
    ``<prefix>.<stage>``, from its ``next`` to the next ``next`` or the
    block's end.  With a dict ``out``, each stage's seconds are added to
    ``out[stage]`` at the end of the block: from the moment the previous
    stage was done, on the host and on ``device``, to the moment this one
    was (the block starts on the host clock).  That needs one wait, at
    the end, and none when ``out`` is None."""

    def __init__(self, prefix: str, device=None, out: dict | None = None):
        self.prefix, self.out = prefix, out
        self.device = _cuda(device)
        self.open = None
        self.marks = []    # (stage, host end, device end event or None)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def _close(self, *exc):
        if self.open is None:
            return
        sp, stage, self.open = self.open, self.open[1], None
        sp[0].__exit__(*exc)
        if self.out is not None:
            ev = None
            if self.device is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(self.device))
            self.marks.append((stage, time.perf_counter(), ev))

    def next(self, stage: str):
        self._close(None, None, None)
        sp = span(f"{self.prefix}.{stage}", self.device)
        sp.__enter__()
        self.open = (sp, stage)

    def __exit__(self, *exc):
        self._close(*exc)
        if self.out is None or not self.marks or exc[0] is not None:
            return False
        last = self.marks[-1][2]
        if last is not None:
            last.synchronize()
        now = time.perf_counter()
        done = self.t0
        for stage, t, ev in self.marks:
            if ev is not None:
                t = max(t, now - ev.elapsed_time(last) * 1e-3)
            self.out[stage] = self.out.get(stage, 0.0) + t - done
            done = t
        return False
