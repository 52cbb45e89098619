"""Host storage: string-key translation (``translate``), id allocation
with reserve/commit sessions (``idalloc``), the RBF page store
(``rbf``, over the C++ in ``csrc/``), per-shard fragment files
(``shards``) and the official roaring format (``roaring``)."""
