"""SQL layer — lexer, parser, planner over the PQL executor.

The analog of the reference's sql3/ (parser + planner):
a hand-written lexer and recursive-descent parser produce a SQL AST;
the planner compiles it into the executor's PQL call trees, keeping
the reference's central optimization — push filters and aggregates
down into per-shard PQL ops (sql3/planner/planoptimizer.go) — while
skipping PlanOpFanout entirely: the executor already spans every
shard on the card.

Table model: a table is an index; ``_id`` is the column id (or key on
keyed tables).  Column types map to fields: ``id``/``string`` scalars
→ mutex fields (keyed for string), ``idset``/``stringset`` → set
fields, ``int`` → BSI, ``decimal(s)``, ``timestamp``, ``bool``.
"""

from pilosa_tpu_torch.sql.engine import SQLEngine, SQLError

__all__ = ["SQLEngine", "SQLError"]
