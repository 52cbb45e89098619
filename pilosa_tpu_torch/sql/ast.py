"""SQL AST node types (shape of sql3/parser/ast.go, subset)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ColumnDef:
    name: str
    type: str            # id,string,int,decimal,timestamp,bool,idset,stringset
    scale: int = 0
    min: int | None = None
    max: int | None = None
    time_quantum: str | None = None
    # timestamp storage granularity + base (sql3 timeunit/epoch
    # column options; defs_date_functions tables)
    time_unit: str | None = None
    epoch: str | None = None


@dataclass
class CreateTable:
    name: str
    columns: list[ColumnDef]
    keys: bool = False   # _id is string-keyed
    if_not_exists: bool = False


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class CreateView:
    """CREATE VIEW name AS SELECT ... (sql3 CREATE VIEW): a stored
    select re-executed when the view is queried."""
    name: str
    select: "Select" = None
    if_not_exists: bool = False


@dataclass
class DropView:
    name: str
    if_exists: bool = False


@dataclass
class ShowViews:
    pass


@dataclass
class ShowTables:
    pass


@dataclass
class ShowColumns:
    table: str = ""


@dataclass
class ShowCreateTable:
    table: str = ""


@dataclass
class AlterTable:
    """ALTER TABLE t ADD [COLUMN] def | DROP [COLUMN] name |
    RENAME [COLUMN] old TO new (sql3/parser AlterTableStatement,
    ast.go:1596; compiled by sql3/planner/compilealtertable.go)."""
    table: str
    op: str                       # add | drop | rename
    column: ColumnDef | None = None   # add
    name: str = ""                # drop: column; rename: old name
    new_name: str = ""            # rename


@dataclass
class Insert:
    table: str
    columns: list[str]
    rows: list[list]
    replace: bool = False


@dataclass
class Delete:
    table: str
    where: Any = None
    alias: str | None = None


# --- expressions -----------------------------------------------------------

@dataclass
class Col:
    name: str
    table: str | None = None  # qualified reference (joins)


@dataclass
class Join:
    """JOIN clause (sql3 opnestedloops.go nested-loop join).  With
    outer=True it is a LEFT [OUTER] JOIN: unmatched left records
    survive with NULL right-side values.  left/right are None for a
    comma join (FROM a, b — a cross product whose condition lives in
    WHERE, sql3/parser parseSource); subquery holds a derived-table
    side (FROM a, (SELECT ...) x)."""
    table: str | None
    left: "Col | None"
    right: "Col | None"
    outer: bool = False
    alias: str | None = None
    subquery: Any = None  # ast.Select for derived-table sides


@dataclass
class Lit:
    value: Any


@dataclass
class BinOp:
    op: str              # = != < <= > >= and or like
    left: Any
    right: Any


@dataclass
class Var:
    """@name parameter reference inside a function body (sql3/parser
    Variable, scanner.go scanVariable)."""
    name: str


@dataclass
class CreateFunction:
    """CREATE FUNCTION name(@p type, ...) RETURNS type AS (expr)
    (sql3/parser CreateFunctionStatement, ast.go:3061).  The reference
    parses this but disables execution — its bodies ran external code
    (userdefinedfunctions.go 'remote code exploit' note); here the
    body is a pure SQL scalar expression over the parameters, so
    evaluation is safe and enabled."""
    name: str
    params: list = field(default_factory=list)   # [(name, sql_type)]
    returns: str = "string"
    body: Any = None
    if_not_exists: bool = False


@dataclass
class DropFunction:
    name: str
    if_exists: bool = False


@dataclass
class ShowFunctions:
    pass


@dataclass
class ShowDatabases:
    """SHOW DATABASES — database scoping is a DAX/cloud concept
    (dax controller schemar); a standalone node reports none."""
    pass


@dataclass
class Copy:
    """COPY src TO dst (sql3/parser copy statement): clone a table's
    schema and records into a new table."""
    src: str
    dst: str


@dataclass
class AlterView:
    """ALTER VIEW name AS SELECT ... — replace a stored view's
    definition (sql3/parser parseAlterViewStatement)."""
    name: str
    select: "Select" = None


@dataclass
class Explain:
    """EXPLAIN stmt (sql3/parser parseExplain): returns the compiled
    plan as rows instead of executing."""
    stmt: Any = None


@dataclass
class Func:
    """Scalar function call — the reference's built-in function
    surface (sql3/planner/expressionanalyzercall.go case list;
    implementations in inbuiltfunctions{string,date,set}.go) plus
    user-defined functions (userdefinedfunctions.go)."""
    name: str            # canonical upper-case
    args: list = field(default_factory=list)


@dataclass
class Not:
    expr: Any


@dataclass
class InList:
    col: Any
    items: list
    negated: bool = False


@dataclass
class InSelect:
    """col [NOT] IN (SELECT ...) — uncorrelated subquery semi-join
    (sql3/planner subquery compilation)."""
    col: Any
    select: "Select"
    negated: bool = False


@dataclass
class SubQuery:
    """Scalar subquery: (SELECT <one aggregate/column> ...) used as a
    value in a comparison."""
    select: "Select"


@dataclass
class Between:
    col: Any
    lo: Any
    hi: Any
    negated: bool = False


@dataclass
class IsNull:
    col: Any
    negated: bool = False


@dataclass
class Agg:
    func: str            # count sum min max avg percentile
    arg: Any = None      # Col or None (count(*))
    distinct: bool = False
    extra: Any = None    # percentile nth


@dataclass
class SelectItem:
    expr: Any            # Col | Agg | Lit
    alias: str | None = None


@dataclass
class OrderBy:
    expr: Any
    desc: bool = False


@dataclass
class BulkInsert:
    """BULK INSERT ... [MAP (...)] [TRANSFORM (...)] FROM 'file'|x'...'
    WITH BATCHSIZE n FORMAT 'CSV' INPUT 'FILE'|'STREAM' (sql3/parser
    bulk-insert statement).  Without MAP, columns map positionally to
    CSV fields; with MAP, each entry is (source, kind, scale) where
    source is a CSV position (int) or record path (str), and TRANSFORM
    expressions (@N = mapped value N) produce the column values;
    header_row skips the first line."""
    table: str
    columns: list[str]
    path: str = ""
    format: str = "CSV"
    input: str = "FILE"
    header_row: bool = False
    # inline payload for INPUT 'STREAM': rows arrive as literal text
    payload: str | None = None
    # MAP (src TYPE, ...): list of (source, kind, scale)
    maps: list | None = None
    # TRANSFORM (expr, ...): one expression per target column
    transforms: list | None = None
    batch_size: int | None = None
    allow_missing: bool = False


@dataclass
class Select:
    items: list[SelectItem] = field(default_factory=list)
    table: str = ""
    joins: list[Join] = field(default_factory=list)
    where: Any = None
    group_by: list = field(default_factory=list)
    having: Any = None
    order_by: list[OrderBy] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    # SELECT TOP(n): normalized onto `limit` by the parser
    # (sql3/parser/parser.go:2376); kept for the TOP+LIMIT conflict
    # check
    top: int | None = None
    # FROM table [AS] alias
    table_alias: str | None = None
    # FROM (SELECT ...) [AS] alias — a derived table (sql3
    # tableOrSubquery; defs_subquery)
    from_select: "Select | None" = None
    # WITH (flatten(col)) query hints: DISTINCT/GROUP BY on these
    # set columns go member-wise (sql3 query hints;
    # defs_groupby groupBySetDistinctTests)
    flatten: list = field(default_factory=list)
