"""Authorization — group -> permission per index (authz/).

Parity with authz/authorization.go: a YAML policy maps IdP group ids
to a permission level per index ("read" < "write" < "admin",
authorization.go:15 Permission ordering); admin grants everything
(:44 IsAdmin), and an index-specific grant is required otherwise
(:59 GetPermissions).

Policy file shape (authorization.go's test fixtures):

    user-groups:
      "group-id-1":
        "indexname": "read"
        "other": "write"
      "group-id-2":
        "indexname": "admin"
    admin: "admin-group-id"
"""

from __future__ import annotations

_LEVELS = {"": 0, "read": 1, "write": 2, "admin": 3}


class Authorizer:
    def __init__(self, user_groups: dict | None = None,
                 admin_group: str = ""):
        self.user_groups = user_groups or {}
        self.admin_group = admin_group

    @classmethod
    def from_yaml(cls, path: str) -> "Authorizer":
        import yaml
        with open(path) as fh:
            doc = yaml.safe_load(fh) or {}
        return cls(user_groups=doc.get("user-groups", {}),
                   admin_group=doc.get("admin", ""))

    def is_admin(self, groups) -> bool:
        return bool(self.admin_group) and self.admin_group in groups

    def permission(self, groups, index: str) -> str:
        """Best permission any of the user's groups grants on index."""
        if self.is_admin(groups):
            return "admin"
        best = ""
        for g in groups:
            p = self.user_groups.get(g, {}).get(index, "")
            if _LEVELS.get(p, 0) > _LEVELS[best]:
                best = p
        return best

    def allowed(self, groups, index: str, need: str) -> bool:
        return _LEVELS[self.permission(groups, index)] >= \
            _LEVELS.get(need, 99)

    def sql_check(self, groups):
        """Per-statement (table, need) hook for SQLEngine.auth_check:
        raises PermissionError on denial.  Untargeted writes require
        admin; untargeted reads (SHOW TABLES) pass — the engine
        filters their rows via the same hook."""
        def check(table, need):
            if table is None:
                if need == "write" and not self.is_admin(groups):
                    raise PermissionError("admin required")
                return
            if not self.allowed(groups, table, need):
                raise PermissionError(
                    f"not authorized for {need} on {table}")
        return check

    def allowed_indexes(self, groups, need: str = "read") -> list[str]:
        """Indexes the user can access at `need` level (query
        filtering, authorization.go GetAuthorizedIndexList)."""
        if self.is_admin(groups):
            return ["*"]
        out = set()
        for g in groups:
            for idx, p in self.user_groups.get(g, {}).items():
                if _LEVELS.get(p, 0) >= _LEVELS.get(need, 99):
                    out.add(idx)
        return sorted(out)
