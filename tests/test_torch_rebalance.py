"""The port's online resharding against the JAX package's.

Two-node clusters of each package (width 2048, eight shards,
``replica_n = 1``, ``tests/torch_cluster_dual.py``) take the same
seeded data; a third node opens ``member=False`` and joins while four
reader threads and a writer run, then a node drains.  The same shards
move in both packages, the recipients' fragments are equal (block
checksums) between them, no read fails or mismatches, and every answer
afterwards equals the JAX cluster's.  A fenced import answers 410 with
the new owner, the client follows it one hop, a coordinator's write
re-plans after a flip, a stream window forwards the moved half of its
mutations to the new owner, and each armed crash seam rolls the move
back and resumes it forward.  Every wait has its own deadline."""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.obs import faults as jax_faults
from pilosa_tpu_torch.cluster import (
    FenceTable,
    InternalClient,
    RebalanceController,
    RebalanceError,
    ShardMovedError,
)
from pilosa_tpu_torch.cluster import rebalance as port_rebalance
from pilosa_tpu_torch.obs import faults as port_faults
from pilosa_tpu_torch.obs import metrics as port_metrics
from torch_cluster_dual import W, both, dual_cluster

torch.set_num_threads(1)

N = 8

SCHEMA = {"indexes": [{"name": "c", "fields": [
    {"name": "f", "options": {"type": "set"}},
    {"name": "v", "options": {"type": "int", "min": 0, "max": 1 << 20}}]}]}

QUERIES = ["Count(Row(f=1))", "Count(Row(f=2))", "Row(f=2)",
           "Sum(Row(f=1), field=v)", "Count(Row(v > 500))"]

FIELDS = (("f", "standard"), ("v", "bsig_v"), ("_exists", "standard"))

# one beat in 30 s keeps resyncs out of a move; the lease outlasts the
# test, so a slow run never marks a node DOWN between two beats
QUIET = {"hb": 30.0, "lease_ttl": 600.0}


def _seed(c, n_shards=N, per_shard=24):
    rng = np.random.default_rng(3)
    rows, cols = [], []
    for s in range(n_shards):
        for c_ in rng.choice(W, size=per_shard, replace=False):
            rows.append(int(rng.integers(1, 4)))
            cols.append(s * W + int(c_))
    vals = [(col * 7) % 1000 for col in cols]
    nd = c.nodes[0]
    nd.apply_schema(SCHEMA)
    nd.import_bits("c", "f", rows, cols)
    nd.import_values("c", "v", cols, vals)


def _writes(n=200, first=200):
    return [((k % N) * W + first + (k // N) % 600, 9) for k in range(n)]


def _holdings(c, n_shards=N):
    """shard -> the sorted slots whose holder has its f fragment."""
    out = {}
    for s in range(n_shards):
        out[s] = sorted(
            i for i, h in enumerate(c.holders)
            if (h.index("c") is not None
                and h.index("c").field("f").views.get("standard")
                is not None
                and h.index("c").field("f").views["standard"]
                .fragments.get(s) is not None))
    return out


def _checksums(node, s):
    return {f: node.api.fragment_checksums("c", f, v, s) for f, v in FIELDS}


class _Storm:
    """4 readers of QUERIES and one writer of ``writes`` (Set of f=9)
    through node0.  ``acked`` holds the columns whose import returned;
    ``known`` the f=9 columns set before the storm.  A reader's
    Count(Row(f=9)) must lie between the acknowledged writes when it
    starts and those when it ends plus the one in flight, and never
    fall, so a write lost mid-move shows during the storm."""

    def __init__(self, c, expected, writes, known=()):
        self.c, self.expected, self.writes = c, expected, writes
        self.known = set(known)
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.acked, self.errors, self.mism = [], [], []
        self.reached = 0
        self.threads = [threading.Thread(target=self._reader, daemon=True)
                        for _ in range(4)] + [
            threading.Thread(target=self._writer, daemon=True)]
        for t in self.threads:
            t.start()

    def n_acked(self):
        with self.lock:
            return len(self.known.union(self.acked))

    def _reader(self):
        i, last = 0, 0
        qs = QUERIES + ["Count(Row(f=9))"]
        while not self.stop.is_set():
            q = qs[i % len(qs)]
            i += 1
            try:
                lo = self.n_acked()
                got = self.c.nodes[0].query("c", q)["results"]
                if q == "Count(Row(f=9))":
                    hi = self.n_acked() + 1
                    if not max(lo, last) <= got[0] <= hi:
                        self.mism.append((q, got, lo, last, hi))
                    last = max(last, got[0])
                elif got != self.expected[q]:
                    self.mism.append((q, got))
            except Exception as e:
                self.errors.append(f"read {type(e).__name__}: {e}")

    def _writer(self):
        for col, row in self.writes:
            if self.stop.is_set():
                break
            try:
                self.c.nodes[0].import_bits("c", "f", [row], [col])
            except Exception as e:
                self.errors.append(f"write {type(e).__name__}: {e}")
                break
            with self.lock:
                self.acked.append(col)
                self.reached += 1

    def finish(self):
        """Stop the threads; check that every acknowledged write reads
        back through node0 and, shard by shard, on each owner, before
        the writes the writer did not reach land.  Returns the f=9
        columns now set."""
        self.stop.set()
        for t in self.threads:
            t.join(timeout=30)
            assert not t.is_alive(), "a storm thread did not stop"
        acked = self.known.union(self.acked)
        c = self.c
        got = c.nodes[0].query("c", "Count(Row(f=9))")["results"]
        assert got == [len(acked)], (c.pkg, got, len(acked), self.reached)
        snap = c.nodes[0].snapshot()
        for s in range(N):
            want = sum(1 for col in acked if col // W == s)
            owner = snap.shard_nodes("c", s)[0].id
            nd = next(nd for nd in c.nodes if nd.node_id == owner)
            got = nd.api.query("c", "Count(Row(f=9))", shards=[s])
            assert got["results"] == [want], (c.pkg, s, owner, got, want)
        # the rest of the writes land now, so both packages end equal
        rest = [col for col, _ in self.writes[self.reached:]]
        if rest:
            c.nodes[0].import_bits("c", "f", [9] * len(rest), rest)
        return acked.union(rest)


def test_join_then_drain_under_reads_and_writes_equal_jax():
    with dual_cluster(n=2, replica_n=1, extra=1, **QUIET) as (jc, pc):
        _seed(jc)
        _seed(pc)
        expected = {q: jc.nodes[0].query("c", q)["results"]
                    for q in QUERIES}
        assert expected == {q: pc.nodes[0].query("c", q)["results"]
                            for q in QUERIES}
        writes = _writes()
        outs, known = {}, {}
        for c in (jc, pc):
            c.node(2, member=False)
            st = _Storm(c, expected, writes)
            outs[c.pkg] = c.nodes[0].rebalance_join("node2")
            known[c.pkg] = st.finish()
            assert not st.errors, st.errors[:5]
            assert not st.mism, st.mism[:5]
        jo, po = outs["jax"], outs["port"]
        assert po["state"] == jo["state"] == "done"
        assert po["shards_moved"] == jo["shards_moved"] > 0
        assert po["moving_partitions"] == jo["moving_partitions"]
        assert pc.disco.roster() == jc.disco.roster() == \
            ["node0", "node1", "node2"]
        assert _holdings(pc) == _holdings(jc)
        for s, slots in _holdings(pc).items():
            for i in slots:
                assert _checksums(pc.nodes[i], s) == \
                    _checksums(jc.nodes[i], s), (s, i)
        allq = QUERIES + ["Count(Row(f=9))", "TopN(f)"]
        for q in allq:
            for i in range(3):
                j, p = both(jc, pc, lambda c: c.nodes[i].query("c", q))
                assert p == j, (q, i)
        # drain node1 under the same storm
        expected = {q: pc.nodes[0].query("c", q)["results"]
                    for q in QUERIES}
        writes = _writes(first=900)
        for c in (jc, pc):
            st = _Storm(c, expected, writes, known[c.pkg])
            outs[c.pkg] = c.nodes[0].rebalance_drain("node1")
            st.finish()
            assert not st.errors, st.errors[:5]
            assert not st.mism, st.mism[:5]
        assert outs["port"]["shards_moved"] == \
            outs["jax"]["shards_moved"] > 0
        assert pc.disco.roster() == jc.disco.roster() == ["node0", "node2"]
        assert _holdings(pc) == _holdings(jc)
        assert all(1 not in slots for slots in _holdings(pc).values())
        for s, slots in _holdings(pc).items():
            for i in slots:
                assert _checksums(pc.nodes[i], s) == \
                    _checksums(jc.nodes[i], s), (s, i)
        for q in allq:
            j, p = both(jc, pc, lambda c: c.nodes[2].query("c", q))
            assert p == j, q
        st = InternalClient().get_json(pc.nodes[0].uri, "/debug/rebalance")
        assert st["controller"]["state"] == "done"
        assert st["roster"] == ["node0", "node2"]
        assert port_metrics.REBALANCE_BYTES.value(kind="copied") > 0


def test_join_patches_a_warm_recipient_stack():
    """The recipient already serves a stale copy of a shard that moves
    to it (a stack resident on its executor, and a cached result): the
    transfer's block writes go through the delta log and the mutation
    epoch, so its next answer is the donor's, not the stale one."""
    with dual_cluster(n=2, replica_n=1, extra=1, **QUIET) as (_jc, pc):
        _seed(pc)
        j = pc.node(2, member=False)
        snap = pc.nodes[0].snapshot()
        from pilosa_tpu_torch.cluster import roster_diff
        diff = roster_diff(range(snap.partition_n), ["node0", "node1"],
                           ["node0", "node1", "node2"])
        moving = [s for s in range(N) if snap.shard_partition("c", s)
                  in diff]
        assert moving
        s = moving[0]
        want = pc.nodes[0].query("c", f"Count(Row(f=1))")["results"]
        donor = pc.nodes[int(snap.shard_nodes("c", s)[0].id[4:])]
        want_s = donor.api.query("c", "Count(Row(f=1))",
                                 shards=[s])["results"]
        # a stale copy on the joiner: other bits in row 1 of shard s
        j.api.apply_schema(SCHEMA)
        j.api.import_bits("c", "f", rows=[1] * 5,
                          cols=[s * W + c for c in range(5)])
        q = j.api.query("c", "Count(Row(f=1))", shards=[s])["results"]
        assert q == [5]
        pc.nodes[0].rebalance_join("node2")
        assert j.api.query("c", "Count(Row(f=1))",
                           shards=[s])["results"] == want_s
        assert j.query("c", "Count(Row(f=1))")["results"] == want


def _raw(node, method, path, body):
    c = http.client.HTTPConnection("127.0.0.1", node.server.port,
                                   timeout=15)
    try:
        c.request(method, path, body=json.dumps(body))
        r = c.getresponse()
        return r.status, dict(r.getheaders()), json.loads(r.read())
    finally:
        c.close()


def test_fenced_import_answers_410_moved_equal_jax():
    with dual_cluster(n=2, replica_n=1, **QUIET) as (jc, pc):
        _seed(jc)
        _seed(pc)
        outs = []
        for c in (jc, pc):
            c.nodes[0].api.fences.set_moved("c", 1, "node1",
                                            c.nodes[1].uri)
            st, hdrs, body = _raw(
                c.nodes[0], "POST", "/index/c/field/f/import",
                {"rows": [8], "columns": [W + 77]})
            outs.append((st, hdrs.get("X-Pilosa-New-Owner") is not None,
                         sorted(body)))
            # a PQL write to the moved shard answers the same 410
            st2, _h, _b = _raw(c.nodes[0], "POST", "/index/c/query",
                               {"query": f"Set({W + 78}, f=8)"})
            outs.append(st2)
            # a read of it through the fence raises the typed redirect
            with pytest.raises(Exception) as ei:
                c.nodes[0].api.query("c", "Count(Row(f=8))", shards=[1])
            outs.append(type(ei.value).__name__)
        assert outs[:3] == outs[3:]
        assert outs[0][0] == 410 and outs[0][1]
        assert outs[1] == 410
        assert outs[2] == "ShardMovedError"


def test_client_import_redirects_one_hop_equal_jax():
    from pilosa_tpu.cluster import InternalClient as JaxClient
    with dual_cluster(n=2, replica_n=1, **QUIET) as (jc, pc):
        _seed(jc)
        _seed(pc)
        col = W + 77
        for c, client in ((jc, JaxClient()), (pc, InternalClient())):
            c.nodes[0].api.fences.set_moved("c", 1, "node1",
                                            c.nodes[1].uri)
            assert client.import_bits(c.nodes[0].uri, "c", "f", [8],
                                      [col]) == 1
            f1 = c.holders[1].index("c").field("f").views["standard"] \
                .fragments.get(1)
            assert f1 is not None and f1.contains(8, col % W)
            f0 = c.holders[0].index("c").field("f").views["standard"] \
                .fragments.get(1)
            assert f0 is None or not f0.contains(8, col % W)


def test_coordinator_write_replans_after_flip_equal_jax():
    with dual_cluster(n=2, replica_n=1, **QUIET) as (jc, pc):
        _seed(jc)
        _seed(pc)
        col = W + 123
        outs = []
        for c in (jc, pc):
            snap = c.nodes[0].snapshot()
            owner = snap.shard_nodes("c", 1)[0].id
            other = "node1" if owner == "node0" else "node0"
            o, d = int(other[4:]), int(owner[4:])
            c.disco.set_overlay(snap.shard_partition("c", 1), [other],
                                "moved")
            c.nodes[d].api.fences.set_moved("c", 1, other, c.nodes[o].uri)
            outs.append(c.nodes[0].query("c", f"Set({col}, f=7)"))
            frag = c.holders[o].index("c").field("f").views["standard"] \
                .fragments.get(1)
            assert frag is not None and frag.contains(7, col % W)
            outs.append(c.nodes[0].query("c", "Count(Row(f=7))"))
        assert outs[:2] == outs[2:]
        assert outs[2]["results"] == [True] and outs[3]["results"] == [1]


def test_stream_window_reroutes_moved_shard_equal_jax():
    from pilosa_tpu.ingest.stream import StreamWriter as JaxWriter
    from pilosa_tpu_torch.ingest.stream import StreamWriter
    with dual_cluster(n=2, replica_n=1, **QUIET) as (jc, pc):
        _seed(jc)
        _seed(pc)
        for c, cls in ((jc, JaxWriter), (pc, StreamWriter)):
            c.nodes[0].api.fences.set_moved("c", 2, "node1",
                                            c.nodes[1].uri)
            w = cls(c.nodes[0].api, window_s=0.001, sync=False)
            try:
                w.submit("c", "f", rows=[6, 6],
                         cols=[2 * W + 9, 3 * W + 9], timeout=10)
                w.submit("c", "v", values=[77, 88],
                         cols=[2 * W + 10, 3 * W + 10], timeout=10)
            finally:
                w.close()
            f1 = c.holders[1].index("c").field("f").views["standard"] \
                .fragments.get(2)
            assert f1 is not None and f1.contains(6, 9)
            f0 = c.holders[0].index("c").field("f").views["standard"]
            assert f0.fragments.get(3).contains(6, 9)
            got = f0.fragments.get(2)
            assert got is None or not got.contains(6, 9)
        # read back on the new owner: the moved half landed there
        for i in (0, 1):
            for q in ("Count(Row(f=6))", "Sum(field=v)"):
                j, p = both(jc, pc, lambda c: c.nodes[i].api.query(
                    "c", q, shards=[2] if i == 1 else [3]))
                assert p == j, (q, i)


@pytest.mark.parametrize("fault", ["transfer-interrupted",
                                   "recipient-died", "fence-crash"])
def test_crash_seam_rolls_back_then_resumes_equal_jax(fault):
    from pilosa_tpu.cluster import RebalanceController as JaxController
    from pilosa_tpu.cluster import RebalanceError as JaxRebalanceError
    with dual_cluster(n=2, replica_n=1, extra=1, **QUIET) as (jc, pc):
        _seed(jc)
        _seed(pc)
        expected = {q: pc.nodes[0].query("c", q)["results"]
                    for q in QUERIES}
        done = []
        for c, ctl_cls, err, f in (
                (jc, JaxController, JaxRebalanceError, jax_faults),
                (pc, RebalanceController, RebalanceError, port_faults)):
            c.node(2, member=False)
            f.inject(fault, times=1)
            ctl = ctl_cls(c.nodes[0])
            plan = ctl.plan_join("node2")
            with pytest.raises(err):
                ctl.run(plan)
            for nd in c.nodes[:2]:
                for q in QUERIES:
                    assert nd.query("c", q)["results"] == expected[q], q
            for nd in c.nodes:
                assert all(e["state"] != "fencing"
                           for e in nd.api.fences.payload())
            c.nodes[0].import_bits("c", "f", [9], [5])
            out = ctl.resume(plan)
            assert out.state == "done"
            done.append(out.to_dict()["shards_moved"])
            f.clear(fault)
        assert done[0] == done[1]
        for q in QUERIES + ["Count(Row(f=9))"]:
            for i in range(3):
                j, p = both(jc, pc, lambda c: c.nodes[i].query("c", q))
                assert p == j, (q, i)


def test_fence_table_matches_jax():
    from pilosa_tpu.cluster import FenceTable as JaxFenceTable
    from pilosa_tpu.cluster import ShardMovedError as JaxMoved
    outs = []
    for ft, moved in ((JaxFenceTable(), JaxMoved),
                      (FenceTable(), ShardMovedError)):
        ft.begin("i", 2)
        a = ft.active()
        ft.set_moved("i", 2, "n1", "127.0.0.1:1")
        with pytest.raises(moved) as ei:
            ft.check_read("i", [2])
        ft.check_read("i", [1])
        tok = ft.enter_write("i", {1})
        d0 = ft.drain_writes("i", shards={0}, timeout_s=0.1)
        d1 = ft.drain_writes("i", shards={1}, timeout_s=0.1)
        ft.exit_write(tok)
        outs.append((a, ei.value.status, d0, d1, ft.moved_map("i"),
                     [{k: v for k, v in e.items() if k != "since"}
                      for e in ft.payload()]))
    assert outs[0] == outs[1]


def test_rebalance_knobs_through_configure():
    class _N:
        replica_n = 1

        def _client(self):
            return None

        def snapshot(self):
            from pilosa_tpu_torch.cluster import ClusterSnapshot
            return ClusterSnapshot([])

    prev = port_rebalance.settings()
    try:
        port_rebalance.configure(chase_lag=3, max_rounds=5,
                                 fence_timeout_s=0.5)
        k = RebalanceController(_N())
        assert (k.chase_lag, k.max_rounds, k.fence_timeout_s) == (3, 5, 0.5)
        k = RebalanceController(_N(), chase_lag=1)
        assert k.chase_lag == 1
    finally:
        port_rebalance.configure(**prev)


@pytest.mark.parametrize("path", ["import", "pql"])
def test_write_routed_before_the_dual_flip_reaches_the_recipient(path):
    """A write (an import, or a PQL Set) whose routing snapshot predates
    a partition's dual flip reaches the donor only after its fence has
    resolved, so no chase ships it.  The coordinator re-reads the
    placement after the ack and sends the write to the owners it did
    not reach, so the write reads back after the donor releases the
    shard."""
    with dual_cluster(n=2, replica_n=1, extra=1, **QUIET) as (_jc, pc):
        _seed(pc)
        pc.node(2, member=False)
        coord = pc.nodes[0]
        stale = coord.snapshot()
        ctl = RebalanceController(coord)
        plan = ctl.plan_join("node2")
        s = next(s for s in range(N)
                 if stale.shard_partition("c", s) in plan.moving)
        ctl._push_schema("node2")
        ctl._migrate_partition(plan, stale.shard_partition("c", s))
        real, calls = coord.snapshot, []

        def snapshot():
            calls.append(1)
            return stale if len(calls) == 1 else real()

        coord.snapshot = snapshot
        col = s * W + 1999
        late0 = port_metrics.CLUSTER_EVENTS.value(event="late_owner")
        try:
            if path == "import":
                assert coord.import_bits("c", "f", [9], [col]) == 1
            else:
                assert coord.query("c", f"Set({col}, f=9)")["results"] \
                    == [True]
        finally:
            coord.snapshot = real
        assert port_metrics.CLUSTER_EVENTS.value(event="late_owner") \
            == late0 + 1
        assert ctl.run(plan).state == "done"
        assert coord.query("c", "Count(Row(f=9))")["results"] == [1]
        owner = coord.snapshot().shard_nodes("c", s)[0].id
        assert owner == "node2"
        assert pc.nodes[2].api.query("c", "Count(Row(f=9))",
                                     shards=[s])["results"] == [1]
