"""Cluster — the parts a single node's server needs.

- ``txn.py``: exclusive transactions (transaction.go), which hold the
  node read-only while a backup runs.
- ``client.py``: ``InternalClient``, the node-to-node and client HTTP
  transport (internal_client.go), with per-attempt deadlines, retries
  of idempotent reads and the ``rpc-delay``/``rpc-drop`` fault points.

The coordinator, rebalance, discovery, snapshot and hash modules of the
multi-node plane are not ported yet.
"""

from pilosa_tpu_torch.cluster.client import (
    Deadline,
    DeadlineExceeded,
    InternalClient,
    RemoteError,
    ShardMovedError,
)
from pilosa_tpu_torch.cluster.txn import Transaction, TransactionManager

__all__ = ["Deadline", "DeadlineExceeded", "InternalClient", "RemoteError",
           "ShardMovedError", "Transaction", "TransactionManager"]
