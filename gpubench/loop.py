"""The closed loop: each client sends its next request only after the
reply to its last, as a BI or dashboard session does."""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

from gpubench import mix as mixmod


@dataclass
class Request:
    spec: dict
    sent: float                  # perf_counter at the send
    done: float = 0.0            # perf_counter at the reply or error
    reply: dict | None = None
    error: str | None = None


@dataclass
class Window:
    begin: float
    end: float
    requests: list = field(default_factory=list)
    stuck: int = 0               # clients still waiting at the join

    @property
    def seconds(self) -> float:
        return self.end - self.begin


def send(api, index: str, spec: dict) -> dict:
    text = mixmod.render(spec, index)
    return api.sql(text) if spec["front"] == "sql" else api.query(index, text)


class Turns:
    """One stream of specs that the clients take in turn, each its next
    when it is ready."""

    def __init__(self, specs):
        self._it = iter(specs)
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        with self._lock:
            return next(self._it)


def run(api, index: str, specs, clients: int, seconds: float,
        on_client=None, grace_s: float = 120.0) -> Window:
    """Drive ``clients`` clients for ``seconds``: each takes the next
    spec of ``specs`` once its last request is answered, until the
    window closes, and its request in flight then is waited for
    (``grace_s`` at most).  ``on_client(i)`` runs first on each
    client's thread (the traced run's span recorder)."""
    n = clients
    turns = Turns(specs)
    per: list[list] = [[] for _ in range(n)]
    gate = threading.Barrier(n + 1)
    win = Window(0.0, 0.0)

    def client(i: int):
        if on_client is not None:
            on_client(i)
        gate.wait()
        mine = per[i]
        for spec in turns:
            now = time.perf_counter()
            if now >= win.end:
                break
            req = Request(spec, now)
            try:
                req.reply = send(api, index, spec)
            except Exception as e:     # a refused or failed request
                req.error = f"{type(e).__name__}: {e}"
            req.done = time.perf_counter()
            mine.append(req)

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"gpubench-client-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    win.begin = time.perf_counter()
    win.end = win.begin + seconds
    gate.wait()
    for t in threads:
        t.join(max(win.end - time.perf_counter(), 0.0) + grace_s)
    win.stuck = sum(t.is_alive() for t in threads)
    for reqs in per:
        win.requests.extend(reqs)
    return win


def percentile(win: Window, q: float) -> float:
    """The q-quantile (nearest rank) of every request's latency in
    seconds; a failed request misses any limit: it ranks above every
    answered one, and where the quantile falls on one it is infinite."""
    lat = sorted(math.inf if r.error is not None else r.done - r.sent
                 for r in win.requests)
    if not lat:
        return 0.0
    return lat[max(0, math.ceil(q * len(lat)) - 1)]


def answered(win: Window) -> list:
    """Requests answered inside the window."""
    return [r for r in win.requests if r.error is None and r.done <= win.end]
