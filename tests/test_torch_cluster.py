"""The port's cluster plane against the JAX package's.

Placement (``jump_hash``, ``ClusterSnapshot``, ``placement_diff``,
``roster_diff``) equals the JAX functions over seeded shards, indexes,
rosters and overlays.  Then a three-node JAX cluster and a three-node
port cluster (``device="cpu"``, width 2048, ``replica_n = 2``) take the
same seeded schema, replicated imports and PQL writes
(``tests/torch_cluster_dual.py``), and every answer through
``ClusterExecutor.execute`` must be equal: the reads from each node as
coordinator, after a node is closed, ``partial_ok`` answers and
``LoadShedError``, hedged reads under ``rpc-delay``, a ``Deadline``
that expires, a ``warm=True`` rejoin after missed writes, the audit's
replica scrub repairing a diverged replica, and the shapes of the
``/debug/cluster/*`` views.  A repair written into a fragment whose
stack is resident patches the stack: the next read is exact, not
stale.  Every wait polls against its own deadline."""

import http.client
import json

import numpy as np
import pytest
import torch

from pilosa_tpu import cluster as jcl
from pilosa_tpu.obs import faults as jax_faults
from pilosa_tpu.obs import metrics as jax_metrics
from pilosa_tpu_torch import cluster as pcl
from pilosa_tpu_torch.cluster import coordinator
from pilosa_tpu_torch.obs import faults as port_faults
from pilosa_tpu_torch.obs import metrics as port_metrics
from torch_cluster_dual import (
    N_SHARDS,
    W,
    both,
    dual_cluster,
    seed,
    seed_data,
    wait_until,
)

torch.set_num_threads(1)

# -- placement ----------------------------------------------------------------


@pytest.mark.parametrize("seed_", [0, 1, 2, 3])
def test_jump_hash_and_diffs_equal_jax(seed_):
    rng = np.random.default_rng(seed_)
    keys = [int(k) for k in rng.integers(0, 1 << 62, size=400)]
    for n in (1, 2, 3, 7, 17):
        assert [pcl.jump_hash(k, n) for k in keys] == \
            [jcl.jump_hash(k, n) for k in keys]
    for a, b in ((3, 4), (4, 3), (5, 5), (1, 6)):
        assert pcl.placement_diff(keys, a, b) == \
            jcl.placement_diff(keys, a, b)
    old = [f"n{i}" for i in range(4)]
    for new in (old + ["n4"], old[:-1], [old[0], old[2], old[3]]):
        assert pcl.roster_diff(keys, old, new) == \
            jcl.roster_diff(keys, old, new)


def _nodes(mod, n, down=()):
    return [mod.Node(id=f"node{i}", uri=f"127.0.0.1:{9000 + i}",
                     state=(mod.NodeState.DOWN if i in down
                            else mod.NodeState.STARTED))
            for i in range(n)]


@pytest.mark.parametrize("n,replica_n,down", [
    (1, 1, ()), (3, 2, ()), (3, 2, (1,)), (4, 3, (0, 2)), (5, 2, (4,)),
])
def test_snapshot_placement_equal_jax(n, replica_n, down):
    rng = np.random.default_rng(n * 10 + replica_n)
    roster = [f"node{i}" for i in rng.permutation(n)]
    overlays = {int(p): {"phase": ("dual", "moved")[i % 2],
                         "owners": [f"node{(i + 1) % n}"]}
                for i, p in enumerate(rng.integers(0, 256, size=6))}
    for ro, ov in ((None, None), (roster, None), (roster, overlays)):
        j = jcl.ClusterSnapshot(_nodes(jcl, n, down), replica_n,
                                roster=ro, overlays=ov)
        p = pcl.ClusterSnapshot(_nodes(pcl, n, down), replica_n,
                                roster=ro, overlays=ov)
        for index in ("i", "headline", "k"):
            shards = [int(s) for s in rng.integers(0, 2000, size=120)]
            for s in shards:
                assert [x.id for x in p.shard_nodes(index, s)] == \
                    [x.id for x in j.shard_nodes(index, s)]
                assert p.shard_partition(index, s) == \
                    j.shard_partition(index, s)
            for key in ("a", "u17", "zz-top"):
                assert [x.id for x in p.key_nodes(index, key)] == \
                    [x.id for x in j.key_nodes(index, key)]
            for exclude in (frozenset(), frozenset({"node0"})):
                assert p.shards_by_node(index, shards, exclude) == \
                    j.shards_by_node(index, shards, exclude)
        assert (p.primary().id if p.primary() else None) == \
            (j.primary().id if j.primary() else None)


# -- the two clusters -----------------------------------------------------------


@pytest.fixture(scope="module")
def seeded():
    data = seed_data()
    with dual_cluster() as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        yield jc, pc


READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=0), Row(g=5)))",
    "Count(Not(Row(f=2)))",
    "TopN(f)",
    "TopN(g, n=3)",
    "TopN(g, Row(f=1), n=4)",
    "TopK(g, k=2)",
    "Sum(field=v)",
    "Sum(Row(f=3), field=v)",
    "Count(Row(v > 100))",
    "Count(Row(-10 < v < 500))",
    "Count(Row(v == 7))",
    "Min(field=v)",
    "Max(Row(g=1), field=v)",
    "Distinct(field=v)",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(m), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), filter=Row(f=0), limit=4)",
    "Row(f=1)",
    "Row(m=2)",
    "Rows(g)",
    "Sort(Row(f=1), field=v, limit=6)",
    "Sort(Row(g=3), field=v, sort-desc=true, offset=2, limit=4)",
    "Extract(Sort(Row(f=2), field=v, limit=5), Rows(f), Rows(m))",
    "Count(Row(f=1))Count(Row(f=2))",
]


@pytest.mark.parametrize("coord", [0, 1, 2])
@pytest.mark.parametrize("q", READS)
def test_cluster_reads_equal_jax(seeded, q, coord):
    jc, pc = seeded
    j, p = both(jc, pc, lambda c: c.nodes[coord].query("c", q))
    assert p == j


def _solo(data):
    """One JAX node's API over all of ``seed``'s data: its one-node
    GroupBy Min and Max are the reference for the cluster's."""
    from pilosa_tpu.api import API
    from pilosa_tpu.models.holder import Holder
    from torch_cluster_dual import SCHEMA
    api = API(Holder(width=W))
    api.apply_schema(SCHEMA)
    api.import_bits("c", "f", rows=data["f"], cols=data["cols"])
    api.import_bits("c", "g", rows=data["g"], cols=data["g_cols"])
    api.import_bits("c", "m", rows=data["m"], cols=data["cols"])
    api.import_values("c", "v", cols=data["cols"], values=data["v"])
    for i, (col, row) in enumerate(data["writes"]):
        api.query("c", f"{'Set' if i % 3 else 'Clear'}({col}, f={row})")
    return api


@pytest.mark.parametrize("q", [
    "GroupBy(Rows(f), aggregate=Max(field=v))",
    "GroupBy(Rows(f), Rows(m), aggregate=Min(field=v))",
    "GroupBy(Rows(g), filter=Row(f=2), aggregate=Max(field=v))",
])
def test_groupby_min_max_aggregate_combines_by_extreme(seeded, q):
    """A GroupBy Min or Max aggregate over the cluster equals one JAX
    node's answer over all the data: the nodes' extremes combine by min
    or max.  The JAX coordinator adds them (a deliberate difference), so
    against the JAX cluster only the counts agree."""
    jc, pc = seeded
    want = _solo(seed_data()).query("c", q)["results"][0]
    key = lambda gs: sorted(gs, key=lambda g: json.dumps(g["group"]))
    got = pc.nodes[0].query("c", q)["results"][0]
    assert key(got) == key(want)
    assert any(g.get("agg") for g in got)
    jgot = jc.nodes[0].query("c", q)["results"][0]
    assert [g["count"] for g in key(jgot)] == [g["count"] for g in key(got)]


@pytest.mark.parametrize("q", [
    'Row(tag="red")', 'Count(Row(tag="blue"))', "TopN(tag)",
    'Rows(tag)', "Count(All())",
])
def test_cluster_keyed_reads_equal_jax(seeded, q):
    jc, pc = seeded
    j, p = both(jc, pc, lambda c: c.nodes[1].query("k", q))
    assert p == j


def test_replicas_hold_equal_fragments(seeded):
    """Each shard's owners hold the same rows in both packages: the
    replicated writes reached every replica."""
    jc, pc = seeded
    snap = pc.nodes[0].snapshot()
    for s in range(N_SHARDS):
        owners = [nd.id for nd in snap.shard_nodes("c", s)]
        assert len(owners) == 2
        for oid in owners:
            i = int(oid[4:])
            for fname in ("f", "g", "m", "v"):
                jq = jc.nodes[i].api.fragment_checksums(
                    "c", fname, "standard" if fname != "v" else "bsig_v", s)
                pq = pc.nodes[i].api.fragment_checksums(
                    "c", fname, "standard" if fname != "v" else "bsig_v", s)
                assert pq == jq


# -- failure paths ----------------------------------------------------------------


def _hedge_ms(ms):
    """The hedge delay of both clusters: the JAX coordinator's env twin
    and the port's configure()."""
    import os
    os.environ["PILOSA_TPU_CLUSTER_HEDGE_MS"] = str(ms)
    coordinator.configure(hedge_ms=ms)


FAILOVER_READS = ["Count(Row(f=1))", "TopN(g, n=3)", "Sum(field=v)",
                  "GroupBy(Rows(f), Rows(m))", "Row(f=2)",
                  "Sort(Row(f=0), field=v, limit=5)", "Distinct(field=v)"]


def test_reads_after_a_node_closes_equal_jax():
    """A node that dies (``pause``: its socket closes, its beats stop)
    fails over to the replicas, exactly; a node that leaves cleanly
    (``close`` deregisters it) takes its shards out of the placement in
    both packages alike, which is why a node drains before it leaves."""
    data = seed_data(11)
    with dual_cluster() as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        want = {q: jc.nodes[0].query("c", q) for q in FAILOVER_READS}
        for c in (jc, pc):
            c.nodes[2].pause()
        for q in FAILOVER_READS:
            j, p = both(jc, pc, lambda c: c.nodes[0].query("c", q))
            assert p == j, q
            # TopN ranks each node's group before the merge (the
            # reference's approximate TopN), so its answer may move
            # when the groups do; every other call stays exact
            if not q.startswith("TopN"):
                assert p == want[q], q
        assert {n.id: n.state for n in pc.disco.nodes()}["node2"] == \
            pcl.NodeState.DOWN
        # writes land on the surviving owners, and the reads see them
        for c in (jc, pc):
            c.nodes[1].executor.execute("c", f"Set({3 * W + 5}, f=1)")
            c.nodes[0].import_bits("c", "g", [5, 5], [1, W + 1])
        for q in FAILOVER_READS + ["Count(Row(g=5))"]:
            j, p = both(jc, pc, lambda c: c.nodes[1].query("c", q))
            assert p == j, q
        for c in (jc, pc):
            c.nodes[1].close()
        for q in FAILOVER_READS:
            j, p = both(jc, pc, lambda c: c.nodes[0].query("c", q))
            assert p == j, q


def test_partial_ok_and_load_shed_equal_jax():
    data = seed_data(12)
    with dual_cluster(replica_n=1) as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        full = both(jc, pc,
                    lambda c: c.nodes[0].query("c", "Count(Row(f=1))"))
        assert full[0] == full[1]
        for c in (jc, pc):
            c.nodes[2].pause()
        shed = []
        for c, mod in ((jc, jcl), (pc, pcl)):
            with pytest.raises(mod.LoadShedError) as ei:
                c.nodes[0].query("c", "Count(Row(f=1))")
            assert ei.value.status == 503
            shed.append(ei.value.missing_shards)
        assert shed[0] == shed[1] and shed[1]
        for q in ("Count(Row(f=1))", "TopN(g, n=2)", "TopK(f, k=3)"):
            j, p = both(jc, pc, lambda c: c.nodes[0].query(
                "c", q, partial_ok=True))
            assert p == j
            assert p["partial"]["missing_shards"] == shed[1]
        # a row's columns would be silently wrong: it sheds
        for c, mod in ((jc, jcl), (pc, pcl)):
            with pytest.raises(mod.LoadShedError):
                c.nodes[0].query("c", "Row(f=1)", partial_ok=True)


def test_hedged_reads_under_rpc_delay_equal_jax():
    data = seed_data(13)
    with dual_cluster() as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        want = both(jc, pc, lambda c: c.nodes[0].query(
            "c", "Count(Row(f=1))"))
        assert want[0] == want[1]
        fired = (jax_metrics.CLUSTER_EVENTS.value(event="hedge_fired"),
                 port_metrics.CLUSTER_EVENTS.value(event="hedge_fired"))
        jax_faults.inject("rpc-delay", match=jc.nodes[1].uri, times=0,
                          delay_s=1.5)
        port_faults.inject("rpc-delay", match=pc.nodes[1].uri, times=0,
                           delay_s=1.5)
        _hedge_ms(25)
        for q in ("Count(Row(f=1))", "Sum(field=v)", "TopN(g, n=2)"):
            j, p = both(jc, pc, lambda c: c.nodes[0].query("c", q))
            assert p == j, q
        assert jax_metrics.CLUSTER_EVENTS.value(
            event="hedge_fired") > fired[0]
        assert port_metrics.CLUSTER_EVENTS.value(
            event="hedge_fired") > fired[1]
        # slow is not dead: the delayed node stays STARTED
        assert {n.id: n.state for n in pc.disco.nodes()}["node1"] == \
            pcl.NodeState.STARTED


def test_deadline_expiry_equal_jax():
    data = seed_data(14)
    with dual_cluster(replica_n=1) as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        for c, f in ((jc, jax_faults), (pc, port_faults)):
            c.nodes[0].query("c", "Count(Row(f=1))")
            for i in (1, 2):
                f.inject("rpc-delay", match=c.nodes[i].uri, times=0,
                         delay_s=1.0)
        for c, mod in ((jc, jcl), (pc, pcl)):
            with pytest.raises(mod.DeadlineExceeded) as ei:
                c.nodes[0].query("c", "Count(Row(f=1))", deadline_s=0.2)
            assert ei.value.status == 504
            # the caller's budget is not the replicas' fault
            assert all(n.state == mod.NodeState.STARTED
                       for n in c.disco.nodes())
        # through configure(): the default deadline applies to a query
        # that passes none
        jax_faults.clear()
        port_faults.clear()
        port_faults.inject("rpc-delay", match=pc.nodes[1].uri, times=0,
                           delay_s=1.0)
        coordinator.configure(deadline_s=0.2)
        with pytest.raises(pcl.DeadlineExceeded):
            pc.nodes[0].query("c", "Count(Row(f=1))")
        coordinator.configure(deadline_s=0.0)


def test_warm_rejoin_repairs_missed_writes_equal_jax():
    data = seed_data(15)
    with dual_cluster(lease_ttl=1.0, hb=0.1) as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        queries = ["Count(Row(f=1))", "Sum(field=v)", "TopN(g, n=4)"]
        for c in (jc, pc):
            for q in queries:  # flight records feed the prefill
                c.nodes[0].query("c", q)
            c.nodes[2].pause()
        for c in (jc, pc):
            wait_until(lambda: {n.id: n.state for n in c.disco.nodes()}
                       ["node2"] == "DOWN", 10.0, "node2 marked DOWN")
        # writes node2 misses, on shards it owns
        snap = pc.nodes[0].snapshot()
        owned = [s for s in range(N_SHARDS)
                 if "node2" in [n.id for n in snap.shard_nodes("c", s)]]
        assert owned
        cols = [s * W + 17 for s in owned]
        for c in (jc, pc):
            c.nodes[0].import_bits("c", "f", [7] * len(cols), cols)
            c.nodes[1].executor.execute("c", f"Set({owned[0] * W + 3}, g=9)")
            c.nodes[0].import_values("c", "v", cols, [999] * len(cols))
        rejoined = [c.node(2, warm=True) for c in (jc, pc)]
        js, ps = [r.warm_stats for r in rejoined]
        assert ps["sync"]["blocks"] == js["sync"]["blocks"] > 0
        assert ps["prefilled"] > 0
        for q in queries + ["Count(Row(f=7))", "Count(Row(g=9))"]:
            j, p = both(jc, pc, lambda c: c.nodes[2].query("c", q))
            assert p == j, q
        # the rejoined node's fragments equal their live replicas'
        for s in owned:
            other = next(n.id for n in snap.shard_nodes("c", s)
                         if n.id != "node2")
            peer = pc.nodes[int(other[4:])].api
            for fname, view in (("f", "standard"), ("g", "standard"),
                                ("v", "bsig_v")):
                assert rejoined[1].api.fragment_checksums(
                    "c", fname, view, s) == \
                    peer.fragment_checksums("c", fname, view, s)


def test_audit_scrub_repairs_diverged_replica_equal_jax():
    data = seed_data(16)
    with dual_cluster(n=2, replica_n=2) as (jc, pc):
        seed(jc, data)
        seed(pc, data)
        before = both(jc, pc, lambda c: c.nodes[1].api.executor.execute(
            "c", "Count(Row(f=1))")[0])
        assert before[0] == before[1]
        for c in (jc, pc):
            frag = c.nodes[1].api.holder.index("c").field("f") \
                .view("standard").fragment(0)
            for col in (frag.row_columns(1)[:3] if c.pkg == "port"
                        else _jax_cols(frag, 1)[:3]):
                frag.clear_bit(1, int(col))
        scanned = both(jc, pc, lambda c: c.nodes[1].audit_scrub(budget=64))
        assert scanned[0] == scanned[1] > 0
        after = both(jc, pc, lambda c: c.nodes[1].api.executor.execute(
            "c", "Count(Row(f=1))")[0])
        assert after == before
        mism = port_metrics.AUDIT_TOTAL.value(kind="replica",
                                              outcome="mismatch")
        rep = port_metrics.AUDIT_TOTAL.value(kind="replica",
                                             outcome="repaired")
        assert mism > 0 and rep > 0
        q = [e for e in pc.nodes[1].api.executor.serving.audit.quarantine
             if e["kind"] == "replica"]
        assert q and q[-1]["repaired_blocks"] > 0
        # the audit plane's tick calls the hook with its budget
        assert pc.nodes[1].api.executor.serving.audit.replica_scrub == \
            pc.nodes[1].audit_scrub


def _jax_cols(frag, row):
    from pilosa_tpu.ops import bitmap as jbm
    return jbm.to_columns(frag.row_words(row))


def test_repair_patches_a_warm_stack():
    """A block repair lands through the delta log and the mutation
    epoch: a recipient whose stack for the field is resident patches
    it and answers exactly, and its result cache does not serve the
    pre-repair answer."""
    data = seed_data(17)
    with dual_cluster(n=2, replica_n=2) as (_jc, pc):
        seed(pc, data)
        nd = pc.nodes[1]
        ex = nd.api.executor
        want = ex.execute("c", "Count(Row(f=1))")[0]
        frag = nd.api.holder.index("c").field("f").view("standard") \
            .fragment(0)
        frag.clear_bit(1, int(frag.row_columns(1)[0]))
        assert nd.api.query("c", "Count(Row(f=1))")["results"] == [want - 1]
        counters = ex.stacked.cache.counters()
        assert nd.sync_from_peers()["blocks"] > 0
        assert nd.api.query("c", "Count(Row(f=1))")["results"] == [want]
        after = ex.stacked.cache.counters()
        assert after["patches"] > counters["patches"]


def _req(node, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", node.server.port,
                                   timeout=15)
    try:
        c.request(method, path,
                  body=json.dumps(body) if body is not None else None)
        r = c.getresponse()
        raw = r.read()
        try:
            out = json.loads(raw)
        except ValueError:
            out = raw
        return r.status, dict(r.getheaders()), out
    finally:
        c.close()


@pytest.mark.parametrize("path,keys", [
    ("/debug/cluster/queries", {"queries", "nodes", "unreachable",
                                "partial"}),
    ("/debug/cluster/metrics", {"aggregate", "nodes", "per_node",
                                "unreachable", "partial"}),
    ("/debug/cluster/stats", {"aggregate", "nodes", "per_node",
                              "unreachable", "partial"}),
    ("/debug/cluster/incidents", {"incidents", "watchdog", "nodes",
                                  "unreachable", "partial"}),
    ("/debug/cluster/audit", {"quarantine", "per_node", "nodes",
                              "unreachable", "partial"}),
    ("/debug/rebalance", {"node", "fences", "roster", "placement_epoch",
                          "overlays", "controller"}),
])
def test_debug_cluster_views_shapes_equal_jax(seeded, path, keys):
    jc, pc = seeded
    for c in (jc, pc):
        c.nodes[0].query("c", "Count(Row(f=1))")
    (jst, _jh, jb), (pst, _ph, pb) = both(
        jc, pc, lambda c: _req(c.nodes[0], "GET", path))
    assert pst == jst == 200
    assert set(pb) == set(jb) == keys
    if "nodes" in keys:
        assert pb["nodes"] == jb["nodes"] == ["node0", "node1", "node2"]
        assert pb["partial"] is jb["partial"] is False


def test_cluster_flight_record_has_every_node_attempt(seeded):
    jc, pc = seeded
    from pilosa_tpu_torch.obs import flight
    pc.nodes[0].query("c", "Count(Row(g=1))")
    rec = next(r for r in flight.recorder.recent(64)
               if r.get("route") == "cluster")
    nodes = {a["node"] for a in rec.get("attempts", ())}
    assert nodes == {"node0", "node1", "node2"}


def test_cluster_node_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcl.ClusterNode("solo", pcl.InMemDisCo())


@pytest.mark.parametrize("n_bits", [5, 8192, 8193, 40000])
def test_block_checksums_digest_rows_whatever_their_form(n_bits):
    """A row's digest depends on its contents only (sparse or dense
    storage, a dense row cleared back under the threshold); at most
    SPARSE_MAX bits it is the JAX package's digest, and the digests are
    kept until the fragment changes."""
    from pilosa_tpu.models.fragment import Fragment as JaxFragment
    from pilosa_tpu_torch.models.fragment import Fragment
    from pilosa_tpu_torch.ops import bitmap as bm
    w = 1 << 16
    rng = np.random.default_rng(n_bits)
    cols = np.sort(rng.choice(w, size=n_bits, replace=False))
    a = Fragment("i", "f", "standard", 0, width=w)
    a.import_bits(np.full(cols.size, 3), cols)
    b = Fragment("i", "f", "standard", 0, width=w)
    b.import_row_words(3, bm.from_columns(cols, w))  # stored dense
    c = Fragment("i", "f", "standard", 0, width=w)
    extra = np.setdiff1d(np.arange(w), cols)[:9000]
    c.import_bits(np.full(cols.size + extra.size, 3),
                  np.concatenate([cols, extra]))
    for col in extra.tolist():  # dense, cleared back to cols
        c.clear_bit(3, col)
    sums = a.block_checksums()
    assert sums == b.block_checksums() == c.block_checksums()
    j = JaxFragment("i", "f", "standard", 0, width=w)
    j.import_bits(np.full(cols.size, 3), cols)
    assert (sums == j.block_checksums()) == (n_bits <= 8192)
    assert a.block_checksums() is not a._sums[1]
    a.set_bit(70, 1)
    assert set(a.block_checksums()) == {0, 1}


def test_rejoin_keeps_beating_through_a_long_resync():
    """A resync longer than the lease (full width takes ~20 s against a
    5 s lease) leaves the node STARTED: the beats run from registration
    on, and the resync after a revival runs beside them.  (The JAX node
    beats only after its post-register resync, so it is marked DOWN
    during one and then resyncs again from its heartbeat loop.)"""
    import time as _time
    data = seed_data(18)
    with dual_cluster(n=2, lease_ttl=0.5, hb=0.1) as (_jc, pc):
        seed(pc, data)
        pc.nodes[1].pause()
        wait_until(lambda: {n.id: n.state for n in pc.disco.nodes()}
                   ["node1"] == "DOWN", 10.0, "node1 marked DOWN")
        real = pcl.ClusterNode.sync_from_peers
        calls = []

        def slow(self):
            calls.append(_time.monotonic())
            out = real(self)
            _time.sleep(1.5)  # three leases
            return out
        pcl.ClusterNode.sync_from_peers = slow
        try:
            nd = pc.node(1, warm=True)
            end = _time.monotonic() + 2.0
            while _time.monotonic() < end:
                assert {n.id: n.state for n in pc.disco.nodes()}[
                    "node1"] == "STARTED"
                _time.sleep(0.05)
        finally:
            pcl.ClusterNode.sync_from_peers = real
        assert len(calls) == 2  # the bulk pass and the post-register one
        assert nd.query("c", "Count(Row(f=1))") == \
            pc.nodes[0].query("c", "Count(Row(f=1))")


def test_batched_checksums_equal_the_per_shard_route():
    """The port's POST .../{view}/checksums, which a rejoin asks of its
    peer, answers what the per-shard route does for each shard."""
    from pilosa_tpu_torch.cluster.client import InternalClient
    from pilosa_tpu_torch.server.http import Server
    from torch_server_dual import build_holder, configs, restore_globals
    with restore_globals():
        ps = Server(holder=build_holder("port"), port=0,
                    config=configs()[1], device="cpu").start()
        try:
            client = InternalClient()
            peer = type("P", (), {"uri": f"127.0.0.1:{ps.port}"})()
            got = pcl.ClusterNode._peer_checksums(
                None, client, peer, "i", "s", "standard", [0, 1, 2, 3, 9])
            per = {s: client.get_json(f"127.0.0.1:{ps.port}",
                                      f"/internal/fragment/i/s/standard/{s}"
                                      "/checksums") for s in (0, 1, 2, 3, 9)}
        finally:
            ps.close()
    assert got == per
    assert per[9] == {} and per[0]


def test_row_ids_beside_a_replica_write_of_dense_rows():
    """Reading a fragment's rows while a repair or transfer writes whole
    dense rows into it (numpy releases the interpreter lock inside a
    row's scan) neither raises nor misses a row: row_ids walks the
    written rows under the fragment's lock."""
    import threading
    from pilosa_tpu_torch.models.fragment import Fragment
    w = 1 << 20
    f = Fragment("i", "t", "standard", 0, width=w)
    full = np.full(w // 32, 0xFFFF, np.uint32)
    for r in range(8):
        f.set_row_words(r, full)
    stop = threading.Event()
    errors = []

    def writer():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            f.set_row_words(int(rng.integers(8, 64)), full)

    def reader():
        while not stop.is_set():
            try:
                assert set(range(8)) <= set(f.row_ids)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
                return
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    import time as _time
    _time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(10)
    assert not errors, errors[:1]
    assert f.row_ids == sorted(set(f.row_ids))
