"""The readers of the program's own spans and counters (the serving
layer's admission and batch leader, the stacked engine's launch phase,
the garbage collector's passes, the audit's shadow time) on a recorded
trace, and what each reads where the program has none of them."""

import gc
import time

import pytest

from gpubench import metrics as readers
from gpubench.loop import Request, Window
from gpubench.trace import Bundle


def recorded() -> Bundle:
    # a 2 s window, the card busy over [0.1, 0.45], [1.0, 1.1] and
    # [1.9, 2.0]: idle 1.45 s; three batches, one past the window's end
    device = [("popcount_rows_kernel(...)", 0.10, 0.20),
              ("void groupby_joint_kernel<7>(...)", 0.15, 0.45),
              ("Memcpy HtoD", 1.00, 1.10),
              ("popcount_rows_kernel(...)", 1.90, 2.30)]
    spans = [("executor.Execute", 0.2, 1.5), ("serving.batch", 0.3, 0.5),
             ("serving.batch", 0.4, 0.6), ("serving.plan", 0.5, 0.9),
             ("serving.batch", 1.8, 2.4)]
    flight = [{"phases": {"admit": 2.0, "execute": 4.0, "launch": 1.0,
                          "sync": 3.0}},
              {"phases": {"admit": 6.0, "execute": 2.0, "launch": 0.5,
                          "sync": 1.5}},
              {"phases": {}}, {"phases": {"launch": 0.5}}]
    win = Window(0.0, 2.0, [Request({}, 0.0, 0.1 * (i + 1)) for i in range(4)])
    b = Bundle(window=win, answered=4, flight=flight, counters={},
               launches={}, costs={}, device=device, spans=spans)
    b.busy_s = 0.35 + 0.1 + 0.1
    return b


@pytest.fixture
def gc_passes(monkeypatch):
    from pilosa_tpu_torch.obs import runtime
    passes = [(0.5, 0.7, 2), (1.05, 1.2, 0), (1.95, 2.5, 1), (-1.0, -0.5, 2)]
    monkeypatch.setattr(runtime, "installed", lambda: True)
    monkeypatch.setattr(runtime, "passes",
                        lambda since: [p for p in passes if p[1] >= since])
    return runtime


@pytest.mark.parametrize("name, want", [
    ("serving.admit_ms", 2.0),
    ("stacked.launch_ms", 0.5),
    # [0.3, 0.6] and [1.8, 2.0] of the window, over 4 queries
    ("serving.leader_ms", 1e3 * 0.5 / 4),
])
def test_reader(name, want):
    assert readers.load(name).read(recorded()) == pytest.approx(want)


def test_gc_idle_share(gc_passes):
    # idle [0, 0.1], [0.45, 1.0], [1.1, 1.9]: the passes cover 0.2 + 0.1
    # of 1.45
    got = readers.load("runtime.gc_idle_share").read(recorded())
    assert got == pytest.approx(100 * 0.3 / 1.45)


def test_gc_idle_share_when_the_ring_wrapped(gc_passes, monkeypatch):
    monkeypatch.setattr(gc_passes, "passes", lambda since: None)
    assert readers.load("runtime.gc_idle_share").read(recorded()) is None


def test_shadow_busy_share(monkeypatch):
    from pilosa_tpu_torch.obs import audit
    monkeypatch.setattr(audit, "shadow_seconds",
                        lambda at=None: {0.0: 3.0, 2.0: 4.5}[at])
    got = readers.load("audit.shadow_busy_share").read(recorded())
    assert got == pytest.approx(75.0)


def test_nothing_to_read(monkeypatch):
    """A program without the spans, phases and counters (the parent of
    the change that added them) gives each reader nothing to read: it
    returns None and does not raise."""
    from pilosa_tpu_torch.obs import audit, runtime
    b = recorded()
    b.flight = [{"phases": {"execute": 1.0}}]
    b.spans = [("executor.Execute", 0.2, 1.5)]
    monkeypatch.delattr(audit, "shadow_seconds")
    monkeypatch.setattr(runtime, "installed", lambda: False)
    for name in ("serving.admit_ms", "stacked.launch_ms",
                 "serving.leader_ms", "runtime.gc_idle_share",
                 "audit.shadow_busy_share"):
        assert readers.load(name).read(b) is None


def test_gc_idle_share_reads_the_program():
    """A collection inside the window, with the card idle all of it,
    covers a share of the idle time above 0."""
    from pilosa_tpu_torch.obs import runtime
    runtime.install()
    t0 = time.perf_counter()
    gc.collect()
    t1 = time.perf_counter()
    b = recorded()
    b.window = Window(t0, t1, b.window.requests)
    b.device = [("spin_kernel", t0 - 1.0, t0 - 0.5)]
    got = readers.load("runtime.gc_idle_share").read(b)
    assert 0 < got <= 100
