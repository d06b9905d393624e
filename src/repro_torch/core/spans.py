"""Spans of the sweep and of the event loop: where the host's time goes,
and on a CUDA device the card's time per stage of the loop.

A span is a named interval of the host's clock (``time.perf_counter_ns``)
with its own id, its parent's id, the id of the ``sweep`` span (one
``run_sweep`` call) it lies in, and optional attributes (``it``: the
loop iteration, from ``engine.COUNTS``; ``device_ms``: the stage's card
time). The names and their nesting::

    sweep                       run_sweep
      sweep.simulate            one heuristic (simulate_sweep)
        engine.setup            run() before the loop
        engine.iter             one loop iteration
          engine.next_event     the gaters and the next event time
          engine.check          the periodic check (check iterations)
          engine.<stage>        each stage of engine.STAGES that runs,
                                with its observers' notify
          engine.freeze         steps, the freeze of state and aux
        engine.finish           the metrics and the observers' finalize
        sweep.drain             a synchronize, only while recording
        sweep.to_host           the copy of the results to numpy
      sweep.wrap                the reshape and SweepResult

The pass that ends the loop (its check finds no replicate active) is no
iteration: its ``engine.next_event`` and ``engine.check`` lie directly
under ``sweep.simulate`` (or whatever encloses the loop).

Recording is off unless a ``with recording() as rec:`` block is open,
and then everything stays in memory until the block ends. While off, a
span site costs a test of :func:`current`: no object is made, no event
recorded, no op run. The loop reads the switch once per simulation.
No ``record_function`` and no NVTX range is used, so a profiler's device
records are the same with the recorder on and off.

On a CUDA device the loop also records a ``torch.cuda.Event`` at each
boundary between the spans under ``engine.iter`` (and one as the loop
starts), so each such span's card time is the interval between the
event that opens it and the one that closes it; the intervals of one
loop telescope. They are read (:meth:`Recorder.resolve`) once the
results have been copied to the host, never inside the loop. On the CPU
no event is recorded and no span has ``device_ms``.

``Recorder.clock`` pairs ``perf_counter_ns`` with ``time.time_ns`` at the
start, so a span maps onto the Unix clock of a profiler's device records
(:func:`to_unix_ns`).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import pathlib
import time

#: The recorder of the open ``recording()`` block, or ``None``.
_REC = None

_NULL = contextlib.nullcontext()

#: The name under which :func:`idle_by_span` files time no span covers.
NO_SPAN = "(no span)"


class Span:
    """One recorded interval; ``end`` is ``None`` while it is open."""

    __slots__ = ("name", "start", "end", "id", "parent", "sweep", "attrs")

    def __init__(self, name, start, id, parent, sweep, attrs):
        self.name, self.start, self.end = name, start, None
        self.id, self.parent, self.sweep, self.attrs = id, parent, sweep, attrs

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6

    def to_dict(self, clock: tuple) -> dict:
        """The span as JSON-ready fields, its times also on the Unix
        clock through ``clock`` (its recorder's)."""
        return dict(name=self.name, id=self.id, parent=self.parent,
                    sweep=self.sweep, start_ns=self.start, end_ns=self.end,
                    start_unix_ns=to_unix_ns(clock, self.start),
                    end_unix_ns=to_unix_ns(clock, self.end), **self.attrs)

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.start}..{self.end}, {self.attrs})")


class Recorder:
    """The spans of one ``recording()`` block, in the order they opened."""

    def __init__(self):
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self.spans: list[Span] = []
        self._open: list[Span] = []
        self._bounds: list = []     # (span, opening event, closing event)
        self._chain = None          # the loop's last boundary event

    # ---- spans
    def open(self, name: str, t: int | None = None, **attrs) -> Span:
        parent = self._open[-1] if self._open else None
        sid = len(self.spans)
        sweep = sid if name == "sweep" else (
            parent.sweep if parent is not None else None)
        sp = Span(name, time.perf_counter_ns() if t is None else t, sid,
                  None if parent is None else parent.id, sweep, attrs)
        self.spans.append(sp)
        self._open.append(sp)
        return sp

    def close(self, t: int | None = None) -> Span:
        """Close the innermost open span."""
        sp = self._open.pop()
        sp.end = time.perf_counter_ns() if t is None else t
        return sp

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = self.open(name, **attrs)
        try:
            yield sp
        finally:
            # an exception may leave inner spans of the loop open
            while self._open and self._open[-1] is not sp:
                self.close()
            self.close()

    # ---- the loop's stages and their device boundaries
    def start_chain(self, device) -> None:
        """Begin a loop's device boundaries on ``device`` (none off
        CUDA)."""
        self._chain = None
        if device.type == "cuda":
            self._chain = self._event()

    def _event(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin_iter(self, it: int) -> None:
        """Open ``engine.iter`` (``it``: its iteration) and, at the same
        instant, its first stage, ``engine.next_event``."""
        self.open("engine.next_event", self.open("engine.iter", it=it).start)

    def switch(self, name: str, t: int | None = None) -> None:
        """Close the open stage and open ``name`` in its place at the
        same instant, with a device boundary between them."""
        t = self._close_stage(t).end
        self.open(name, t)

    def end_iter(self, t: int | None = None) -> None:
        """Close the open stage, at a device boundary, and its
        iteration, at one instant."""
        self.close(self._close_stage(t).end)

    def drop_iter(self, t: int | None = None) -> None:
        """Close the open stage and take its iteration out of the
        record, its children going to its parent: the pass whose check
        ends the loop is no iteration."""
        self._close_stage(t)
        sp = self._open.pop()
        for s in self.spans[sp.id + 1:]:
            if s.parent == sp.id:
                s.parent = sp.parent
        self.spans[sp.id] = None

    def _close_stage(self, t: int | None) -> Span:
        sp = self.close(t)
        if self._chain is not None:
            ev = self._event()
            self._bounds.append((sp, self._chain, ev))
            self._chain = ev
        return sp

    def resolve(self) -> None:
        """Read the pending boundary events into ``device_ms``; call it
        after the card has passed them (a synchronize, or a copy to the
        host)."""
        for sp, a, b in self._bounds:
            sp.attrs["device_ms"] = a.elapsed_time(b)
        self._bounds.clear()

    def _finish(self) -> None:
        if self._bounds:
            self._bounds[-1][2].synchronize()
            self.resolve()
        while self._open:
            self.close()
        self.spans = [s for s in self.spans if s is not None]


def current() -> Recorder | None:
    """The recorder of the open ``recording()`` block, or ``None``."""
    return _REC


@contextlib.contextmanager
def recording():
    """Record spans while the block runs; the recorder it yields holds
    them, whole, once the block has ended."""
    global _REC
    if _REC is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _REC = Recorder()
    try:
        yield rec
    finally:
        _REC = None
        rec._finish()


def span(name: str, **attrs):
    """A context manager that records ``name`` while recording, and does
    nothing otherwise."""
    return _NULL if _REC is None else _REC.span(name, **attrs)


# ---------------------------------------------------------------- reading
def to_unix_ns(clock: tuple, perf_ns: int) -> int:
    """A ``perf_counter_ns`` reading on the Unix clock (ns)."""
    return perf_ns - clock[0] + clock[1]


def children(spans: list) -> dict:
    """``{parent id: [child spans, in order]}``."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def stage_table(spans: list, its=None) -> dict:
    """Per stage of ``engine.iter`` (``engine.`` dropped), in the order
    first seen: ``iters``, the iterations; ``host_ms``, its mean host ms
    over the check iterations but a loop's first (the launch queue empty
    after the check, so the host's own issue time, as
    ``engine.COUNTS["issue_ns"]`` counts it), ``host_ms_all`` over every
    iteration; ``device_ms``, its card ms per iteration (``None`` where
    no event was recorded). ``its``: the ``it`` values to keep (default
    all)."""
    kids = children(spans)
    firsts = {next((c.id for c in cs if c.name == "engine.iter"), None)
              for cs in kids.values()}
    iters = [s for s in spans if s.name == "engine.iter"
             and (its is None or s.attrs["it"] in its)]
    checked = {s.id for s in iters if s.id not in firsts
               and any(c.name == "engine.check" for c in kids.get(s.id, ()))}
    table: dict = {}
    for it_span in iters:
        in_check = it_span.id in checked
        for c in kids.get(it_span.id, ()):
            row = table.setdefault(c.name.partition(".")[2], dict(
                host=0.0, host_all=0.0, device=0.0, has_device=False))
            row["host_all"] += c.ms
            if in_check:
                row["host"] += c.ms
            if "device_ms" in c.attrs:
                row["device"] += c.attrs["device_ms"]
                row["has_device"] = True
    n, n_checked = len(iters), len(checked)
    return {name: dict(
        iters=n,
        host_ms=(r["host"] / n_checked if n_checked else None),
        host_ms_all=r["host_all"] / n,
        device_ms=(r["device"] / n if r["has_device"] else None))
        for name, r in table.items()}


def host_wait_share(spans: list, t0: int, t1: int) -> float:
    """The share of the host's time ``[t0, t1)`` (perf ns) spent in
    ``engine.check``."""
    wait = sum(max(0, min(s.end, t1) - max(s.start, t0)) for s in spans
               if s.name == "engine.check")
    return wait / (t1 - t0)


def _innermost(spans: list) -> tuple:
    """The host's timeline cut where the innermost open span changes:
    ``(starts, ends, names)`` of its pieces, in order, ``NO_SPAN`` where
    no span is open."""
    starts, ends, names = [], [], []

    def piece(a, b, name):
        if b > a:
            starts.append(a)
            ends.append(b)
            names.append(name)

    stack: list = []
    cursor = None
    for s in sorted(spans, key=lambda s: (s.start, s.id)):
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            piece(cursor, top.end, top.name)
            cursor = top.end
        if cursor is not None:
            piece(cursor, s.start, stack[-1].name if stack else NO_SPAN)
        cursor = s.start
        stack.append(s)
    while stack:
        top = stack.pop()
        piece(cursor, top.end, top.name)
        cursor = top.end
    return starts, ends, names


def idle_gaps(busy: list) -> list:
    """The gaps between the union of ``busy`` intervals ``(a, b)``."""
    gaps, end = [], None
    for a, b in sorted(busy):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def idle_by_span(spans: list, clock: tuple, busy: list) -> dict:
    """Seconds of the card's idle gaps, split over the innermost host
    span open during each in proportion to the overlap, summed by name
    (``NO_SPAN`` where none was open). ``busy``: the card's busy
    intervals ``(start, end)`` in Unix ns, such as a profiler's device
    records (``trace_start_ns() + 1000 * start_us``)."""
    starts, ends, names = _innermost(spans)
    out: dict = {}
    for ua, ub in idle_gaps(busy):
        a, b = ua - clock[1] + clock[0], ub - clock[1] + clock[0]
        covered = 0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(starts) and starts[i] < b:
            ov = min(b, ends[i]) - max(a, starts[i])
            if ov > 0:
                out[names[i]] = out.get(names[i], 0.0) + ov * 1e-9
                covered += ov
            i += 1
        if b - a > covered:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - a - covered) * 1e-9
    return out


def write_jsonl(rec: Recorder, path) -> None:
    """One JSON line per span, in the order they opened."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for s in rec.spans:
            f.write(json.dumps(s.to_dict(rec.clock)) + "\n")


def format_stage_table(table: dict) -> str:
    """The per-stage host and device ms per iteration, as text."""
    def cell(v):
        return "-" if v is None else f"{v:.4f}"

    n = max((r["iters"] for r in table.values()), default=0)
    lines = [f"per iteration over {n} iterations: host ms on check "
             f"iterations, host ms on all, device ms",
             f"{'stage':12s} {'host':>9s} {'host all':>9s} {'device':>9s}"]
    for name, r in table.items():
        lines.append(f"{name:12s} {cell(r['host_ms']):>9s} "
                     f"{cell(r['host_ms_all']):>9s} "
                     f"{cell(r['device_ms']):>9s}")
    dev = [r["device_ms"] for r in table.values()
           if r["device_ms"] is not None]
    lines.append(f"{'sum':12s} "
                 f"{cell(sum(r['host_ms'] or 0 for r in table.values())):>9s} "
                 f"{cell(sum(r['host_ms_all'] for r in table.values())):>9s} "
                 f"{cell(sum(dev) if dev else None):>9s}")
    return "\n".join(lines)
