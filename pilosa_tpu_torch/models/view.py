"""View — physical layout of a field (view.go:26-53).

View names: ``standard`` for the primary layout, ``bsig_<field>`` for
BSI bit-planes, and time-quantum views ``standard_YYYY[MM[DD[HH]]]``.
A view owns one Fragment per shard; given the index's ``storage``, a
fragment loads its rows from disk when the view makes it.
"""

from __future__ import annotations

from pilosa_tpu_torch.models.fragment import Fragment
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


def bsi_view_name(field_name: str) -> str:
    return VIEW_BSI_PREFIX + field_name


class View:
    def __init__(self, index: str, field: str, name: str,
                 width: int = SHARD_WIDTH, storage=None,
                 cache_type: str = "none", cache_size: int = 50000):
        self.index_name = index
        self.field_name = field
        self.name = name
        self.width = width
        self.storage = storage
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.fragments: dict[int, Fragment] = {}

    def fragment(self, shard: int, create: bool = False) -> Fragment | None:
        f = self.fragments.get(shard)
        if f is None and create:
            f = Fragment(self.index_name, self.field_name, self.name, shard,
                         self.width, storage=self.storage,
                         cache_type=self.cache_type,
                         cache_size=self.cache_size)
            # two writers making the shard's fragment at once keep one
            f = self.fragments.setdefault(shard, f)
        return f

    @property
    def shards(self) -> list[int]:
        return sorted(self.fragments)
