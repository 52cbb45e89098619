"""Directive — the controller's desired-state spec for one worker.

Reference: dax/directive.go:8 — a full statement of what a compute
node should hold (tables + shard jobs + schema), POSTed to the
worker's /directive endpoint; the worker diffs against its current
state and enacts the changes (api_directive.go:19 ApplyDirective,
:172 enactDirective).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Directive:
    address: str                       # worker this directive targets
    version: int = 0                   # monotonic per worker
    schema: dict = field(default_factory=dict)
    # table -> sorted list of shard ids this worker must serve
    assignments: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"address": self.address, "version": self.version,
                "schema": self.schema,
                "assignments": {t: sorted(s)
                                for t, s in self.assignments.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "Directive":
        return cls(address=d["address"], version=d.get("version", 0),
                   schema=d.get("schema", {}),
                   assignments={t: list(map(int, s))
                                for t, s in
                                d.get("assignments", {}).items()})
