"""Tracing — global Tracer with nop default + profiled query spans.

Reference: tracing/tracing.go:12 (global ``Tracer`` interface, nop
default, opentracing adapter) and the profiled-span machinery
(tracing/tracing.go:22-50) that returns a span tree with timings when
``QueryRequest.Profile=true`` (handler.go:40).  Spans are threaded
through the engine the same way (``start_span`` at every layer).

Every span is on ``time.perf_counter``, the clock a device trace is
placed on, so a span can be intersected with the card's busy and idle
intervals.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Span:
    """One timed operation; children nest via the active-span stack."""

    __slots__ = ("name", "tags", "start", "end", "children")

    def __init__(self, name: str):
        self.name = name
        self.tags: dict = {}
        self.start = time.perf_counter()
        self.end: float | None = None
        self.children: list[Span] = []

    def set_tag(self, key: str, value):
        self.tags[key] = value

    def finish(self):
        if self.end is None:
            self.end = time.perf_counter()

    def copy(self) -> "Span":
        """Deep copy of the finished subtree — a shared span (one
        fused device dispatch serving N queries) is attached to every
        requester's tree as its OWN copy, so no two trees alias."""
        s = Span.__new__(Span)
        s.name = self.name
        s.tags = dict(self.tags)
        s.start = self.start
        s.end = self.end
        s.children = [c.copy() for c in self.children]
        return s

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None
                else time.perf_counter()) - self.start

    def to_dict(self) -> dict:
        d = {"name": self.name, "duration_us": int(self.duration * 1e6)}
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


ProfiledSpan = Span  # profiled spans are plain spans kept in a tree


class Tracer:
    """Records a span tree per thread.  Subclass or use as-is."""

    def __init__(self):
        self._tls = threading.local()

    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    @contextmanager
    def span(self, name: str, **tags):
        s = Span(name)
        s.tags.update(tags)
        st = self._stack()
        if st:
            st[-1].children.append(s)
        st.append(s)
        try:
            yield s
        finally:
            s.finish()
            st.pop()
            self.on_finish(s, root=not st)

    def on_finish(self, span: Span, root: bool):
        """Hook for exporters (opentracing adapter analog)."""


class NopTracer(Tracer):
    @contextmanager
    def span(self, name: str, **tags):
        # a FRESH nop span per call: a single shared mutable instance
        # would let any caller that appends children or pokes
        # start/end corrupt every other caller's span (and leak the
        # child list forever) — pinned by test_nop_span_not_shared
        yield _NopSpan()


class _NopSpan(Span):
    """Inert span: mutators are no-ops, duration is frozen at 0; it
    reads no clock."""

    __slots__ = ()

    def __init__(self):
        self.name = "nop"
        self.tags = {}
        self.start = self.end = 0.0
        self.children = []

    def set_tag(self, key: str, value):
        pass

    def finish(self):
        pass

_global = NopTracer()
_tls = threading.local()


def set_tracer(t: Tracer):
    global _global
    _global = t


def get_tracer() -> Tracer:
    """The active tracer: a per-thread override (profiled queries)
    wins over the process-global tracer."""
    t = getattr(_tls, "tracer", None)
    return t if t is not None else _global


def push_thread_tracer(t: Tracer) -> Tracer | None:
    """Install a tracer for THIS thread only (Profile=true queries on
    a threaded server must not race the process-global tracer).
    Returns the previous thread-local tracer to restore."""
    prev = getattr(_tls, "tracer", None)
    _tls.tracer = t
    return prev


def pop_thread_tracer(prev: Tracer | None):
    _tls.tracer = prev


def start_span(name: str, **tags):
    """StartSpanFromContext analog — context is the thread."""
    return get_tracer().span(name, **tags)


class RecordingTracer(Tracer):
    """Keeps finished root spans; used for Profile=true queries and
    the query-history ring (http_handler.go:540)."""

    def __init__(self, keep: int = 100):
        super().__init__()
        self.roots: list[Span] = []
        self.keep = keep
        self._lock = threading.Lock()

    def on_finish(self, span: Span, root: bool):
        if root:
            with self._lock:
                self.roots.append(span)
                if len(self.roots) > self.keep:
                    self.roots.pop(0)


# ---------------------------------------------------------------------------
# cross-thread trace-context propagation
# ---------------------------------------------------------------------------
# The serving batcher executes a follower's query on the LEADER's
# thread (executor/serving.py); thread-local tracing would silently
# drop every device phase of a fused Profile=true query.  A follower
# captures a TraceContext (its tracer + innermost open span), carries
# it into the leader, and the leader records spans INTO that context
# from its own thread — the follower's span tree then includes the
# leader-executed compile/upload/execute phases.

_ATTACH_LOCK = threading.Lock()


class TraceContext:
    """Handle to another thread's (tracer, parent span)."""

    __slots__ = ("tracer", "parent")

    def __init__(self, tracer: Tracer, parent: Span | None):
        self.tracer = tracer
        self.parent = parent

    def attach(self, span: Span):
        """Graft a FINISHED span (tree) under the captured parent.
        Safe from any thread: appends are serialized by a module lock
        (the owning thread only ever appends too, never removes)."""
        if self.parent is not None:
            with _ATTACH_LOCK:
                self.parent.children.append(span)
        else:
            self.tracer.on_finish(span, root=True)


def capture_context() -> TraceContext | None:
    """This thread's active trace context, or None when nothing
    records (the common untraced case — callers skip all cross-thread
    span work on None, keeping the disabled path overhead-free)."""
    t = get_tracer()
    if isinstance(t, NopTracer):
        return None
    st = t._stack()
    return TraceContext(t, st[-1] if st else None)


class _AttachTracer(Tracer):
    """Thread-local tracer whose finished roots graft into a captured
    TraceContext — spans opened via start_span() on the borrowed
    thread (stack uploads, jit dispatch) land in the right tree."""

    def __init__(self, ctx: TraceContext):
        super().__init__()
        self.ctx = ctx

    def on_finish(self, span: Span, root: bool):
        if root:
            self.ctx.attach(span)


_NOP_TRACER = NopTracer()


# ---------------------------------------------------------------------------
# cross-NODE span serialization
# ---------------------------------------------------------------------------
# Span.start is time.perf_counter() — a node-local monotonic clock
# that means nothing on another host.  A span tree crosses an RPC as
# OFFSETS relative to its own root's start; the receiving coordinator
# re-anchors the tree at the moment it observed the attempt leave
# (caller clock), which is the honest alignment available without
# cross-host clock sync (skew shows as at most the connect latency).

def span_to_wire(span: Span, base: float | None = None) -> dict:
    """Serialize a finished span tree for an RPC trailer.  Every
    ``off_us`` in the tree is relative to the SAME base (the root
    span's start by default), so the receiver shifts the whole tree
    with one anchor."""
    if base is None:
        base = span.start
    d = {"name": span.name,
         "off_us": int((span.start - base) * 1e6),
         "dur_us": int(span.duration * 1e6)}
    if span.tags:
        d["tags"] = dict(span.tags)
    if span.children:
        d["children"] = [span_to_wire(c, base) for c in span.children]
    return d


def span_from_wire(d: dict, anchor: float) -> Span:
    """Rebuild a Span tree from its wire form, anchored at ``anchor``
    (this process's perf_counter timeline) — lets a remote tree graft
    into a local tracer via TraceContext.attach."""
    s = Span.__new__(Span)
    s.name = str(d.get("name", "remote"))
    s.tags = dict(d.get("tags", {}))
    s.start = anchor + d.get("off_us", 0) / 1e6
    s.end = s.start + d.get("dur_us", 0) / 1e6
    s.children = [span_from_wire(c, anchor)
                  for c in d.get("children", ())]
    return s


@contextmanager
def span_into(ctx: TraceContext | None, name: str, **tags):
    """Open a span on THIS thread that records (with everything
    start_span() nests inside it) into `ctx`'s tree.  With ctx=None
    the body is SILENCED, not left on the thread's own tracer: a
    traced batch leader serving an untraced follower must not adopt
    the follower's inner spans (stack fetches etc.) into its own
    profile tree."""
    if ctx is None:
        prev = push_thread_tracer(_NOP_TRACER)
        try:
            yield _NopSpan()
        finally:
            pop_thread_tracer(prev)
        return
    t = _AttachTracer(ctx)
    prev = push_thread_tracer(t)
    try:
        with t.span(name, **tags) as s:
            yield s
    finally:
        pop_thread_tracer(prev)
