"""pilosa_tpu_torch — the PyTorch/CUDA port of pilosa_tpu.

A bitmap index (FeatureBase/Pilosa data model) whose shard stacks live
on an NVIDIA GPU as ``torch.int32`` tensors carrying the packed uint32
words of the reference.  The query path is PQL → ``Executor.execute``
→ the stacked engine (``executor/stacked.py``) → hand-written CUDA
kernels (``ops/kernels.py``, ``ops/csrc/``).

``api.API`` is the facade the server (``server/http.py``, started by
``python -m pilosa_tpu_torch.cli.main server``) calls: queries, SQL,
schema, imports, key translation, transactions; ``ingest`` batches
records into it and ``ingest/stream.py`` coalesces streamed writes into
durable windows; a holder given a path persists in RBF files
(``storage``) and reopens from them.

The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``pilosa_tpu``.  Its entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

__version__ = "0.1.0"

__all__ = ["SHARD_WIDTH", "WORDS_PER_SHARD", "__version__"]
