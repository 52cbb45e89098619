"""A three-node JAX cluster and a three-node port cluster side by side.

``dual_cluster`` opens ``n`` JAX ``ClusterNode``s over one JAX
``InMemDisCo`` and ``n`` port ``ClusterNode``s (``device="cpu"``) over
one port ``InMemDisCo``, with the same node ids, replica count and
holder width, and closes every node it made (paused ones and rejoined
replacements included) on exit.  Hedging is off in both unless the
caller asks for a delay: the JAX nodes read it from
``PILOSA_TPU_CLUSTER_HEDGE_MS`` (their servers' config loads the
environment), the port's from the config each node's server applies.
``restore_globals`` puts back the environment and every switch and
thread the servers touch, and both packages' fault registries are
cleared before and after.

``seed`` feeds both clusters the same schema, replicated imports and
PQL writes (through each cluster's coordinator); ``both`` runs one
callable on each cluster and returns the pair.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from pilosa_tpu.cluster import ClusterNode as JaxNode
from pilosa_tpu.cluster import InMemDisCo as JaxDisCo
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import faults as jax_faults
from pilosa_tpu_torch import config as port_config
from pilosa_tpu_torch.cluster import ClusterNode, InMemDisCo
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import faults as port_faults
from torch_server_dual import restore_globals

W = 2048
N_SHARDS = 8

SCHEMA = {"indexes": [
    {"name": "c", "fields": [
        {"name": "f", "options": {"type": "set"}},
        {"name": "g", "options": {"type": "set"}},
        {"name": "m", "options": {"type": "mutex"}},
        {"name": "v", "options": {"type": "int", "min": -50,
                                  "max": 1000}},
    ]},
    {"name": "k", "keys": True, "fields": [
        {"name": "tag", "options": {"type": "set", "keys": True}},
    ]},
]}


class Cluster:
    """One package's nodes, disco and holders."""

    def __init__(self, pkg, disco, holders, nodes, make):
        self.pkg = pkg
        self.disco = disco
        self.holders = holders
        self.nodes = nodes
        self._make = make
        self.made = list(nodes)  # every node object, for teardown

    def node(self, i, **kw):
        """A new node object for slot ``i`` over its holder (a rejoin)."""
        nd = self._make(i, **kw)
        self.made.append(nd)
        if i < len(self.nodes):
            self.nodes[i] = nd
        else:
            self.nodes.append(nd)
        return nd


def wait_until(cond, timeout_s: float = 10.0, what: str = "condition"):
    """Poll ``cond`` until it holds; fail after ``timeout_s``."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@contextlib.contextmanager
def dual_cluster(n: int = 3, replica_n: int = 2, lease_ttl: float = 5.0,
                 hb: float = 0.2, hedge_ms: float = -1.0, extra: int = 0):
    """(JAX Cluster, port Cluster), each opened, each closed on exit;
    ``extra`` more holders wait for nodes a test opens itself
    (``Cluster.node``), such as a joiner.  The nodes hold
    ``nodes[i]``; a slot past them is appended."""
    with restore_globals():
        jax_faults.clear()
        port_faults.clear()
        os.environ["PILOSA_TPU_CLUSTER_HEDGE_MS"] = str(hedge_ms)
        pcfg = port_config.load(None, env={},
                                overrides={"cluster_hedge_ms": hedge_ms})
        jd = JaxDisCo(lease_ttl=lease_ttl)
        pd = InMemDisCo(lease_ttl=lease_ttl)
        jh = [JaxHolder(width=W) for _ in range(n + extra)]
        ph = [Holder(width=W) for _ in range(n + extra)]

        def jmake(i, warm=False, member=True):
            return JaxNode(f"node{i}", jd, holder=jh[i],
                           replica_n=replica_n,
                           heartbeat_interval=hb).open(warm=warm,
                                                       member=member)

        def pmake(i, warm=False, member=True):
            return ClusterNode(f"node{i}", pd, holder=ph[i],
                               replica_n=replica_n, heartbeat_interval=hb,
                               device="cpu", config=pcfg).open(
                warm=warm, member=member)

        jc = Cluster("jax", jd, jh, [], jmake)
        pc = Cluster("port", pd, ph, [], pmake)
        try:
            for i in range(n):
                jc.nodes.append(jmake(i))
                jc.made.append(jc.nodes[-1])
                pc.nodes.append(pmake(i))
                pc.made.append(pc.nodes[-1])
            yield jc, pc
        finally:
            for c in (jc, pc):
                for nd in c.made:
                    try:
                        nd.close()
                    except Exception:
                        pass
            jax_faults.clear()
            port_faults.clear()


def both(jc, pc, fn):
    """fn(cluster) on each cluster: (JAX answer, port answer)."""
    return fn(jc), fn(pc)


def seed_data(seed: int = 5, n_shards: int = N_SHARDS):
    """Seeded columns, rows and values for ``seed``."""
    rng = np.random.default_rng(seed)
    n = 60 * n_shards
    cols = np.unique(rng.integers(0, W * n_shards, size=n))
    return {
        "cols": cols,
        "f": rng.integers(0, 4, size=cols.size),
        "g_cols": rng.integers(0, W * n_shards, size=n),
        "g": rng.integers(0, 6, size=n),
        "m": rng.integers(0, 3, size=cols.size),
        "v": rng.integers(-50, 1001, size=cols.size),
        "writes": [(int(c), int(r)) for c, r in
                   zip(rng.integers(0, W * n_shards, size=24),
                       rng.integers(0, 4, size=24))],
    }


def seed(cluster, data, coord: int = 0) -> None:
    """The schema, replicated imports and PQL writes, through node
    ``coord`` of one cluster."""
    nd = cluster.nodes[coord]
    nd.apply_schema(SCHEMA)
    nd.import_bits("c", "f", data["f"].tolist(), data["cols"].tolist())
    nd.import_bits("c", "g", data["g"].tolist(), data["g_cols"].tolist())
    nd.import_bits("c", "m", data["m"].tolist(), data["cols"].tolist())
    nd.import_values("c", "v", data["cols"].tolist(), data["v"].tolist())
    for i, (col, row) in enumerate(data["writes"]):
        call = "Set" if i % 3 else "Clear"
        nd.executor.execute("c", f"{call}({col}, f={row})")
    for i in range(12):
        nd.executor.execute("k", f'Set("u{i}", tag="{("red", "blue")[i % 2]}")')
