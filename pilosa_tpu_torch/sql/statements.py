"""DDL + DML statement execution: CREATE/DROP/ALTER TABLE, SHOW,
INSERT, BULK INSERT, DELETE, COPY, CREATE FUNCTION.

Split out of engine.py.  Mirrors sql3/planner's
compilecreatetable.go / compilealtertable.go / compileinsert.go /
compilebulkinsert.go / compilecopy.go behavior on the port's data
model (Holder → Index → Field).
"""

from __future__ import annotations

from pilosa_tpu_torch.models import FieldOptions, FieldType, TimeQuantum
from pilosa_tpu_torch.pql.ast import Call
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.common import (SQLResult, declared_fields,
                                    sql_type_of)
from pilosa_tpu_torch.sql.lexer import SQLError


class StatementExec:
    """DDL/DML executor bound to one SQLEngine."""

    def __init__(self, engine):
        self.eng = engine

    # -- DDL ------------------------------------------------------------

    def create_table(self, stmt: ast.CreateTable) -> SQLResult:
        eng = self.eng
        if stmt.name in eng._views:
            raise SQLError(f"view exists: {stmt.name}")
        if eng.holder.index(stmt.name) is not None:
            if stmt.if_not_exists:
                return SQLResult()
            raise SQLError(f"table already exists: {stmt.name}")
        # validate every column option before creating anything, so a
        # bad column never leaves a half-created table behind
        cols, seen = [], set()
        for cd in stmt.columns:
            if cd.name in seen:
                raise SQLError(f"duplicate column name: {cd.name}")
            seen.add(cd.name)
            if cd.name == "_id":
                continue
            try:
                cols.append((cd.name, self.field_options(cd)))
            except ValueError as e:
                raise SQLError(str(e)) from e
        idx = eng.holder.create_index(stmt.name, keys=stmt.keys)
        for name, opts in cols:
            idx.create_field(name, opts)
        eng.holder.save_schema()
        return SQLResult()

    def field_options(self, cd: ast.ColumnDef) -> FieldOptions:
        t = cd.type
        if t == "int":
            return FieldOptions(type=FieldType.INT, min=cd.min,
                                max=cd.max)
        if t == "decimal":
            return FieldOptions(type=FieldType.DECIMAL, scale=cd.scale,
                                min=cd.min, max=cd.max)
        if t == "timestamp":
            kw = {}
            if cd.time_unit is not None:
                kw["time_unit"] = cd.time_unit
            if cd.epoch is not None:
                from pilosa_tpu_torch.models import timeq
                try:
                    kw["epoch"] = timeq.parse_time(cd.epoch).replace(
                        tzinfo=__import__("datetime").timezone.utc)
                except ValueError as e:
                    raise SQLError(
                        f"invalid value {cd.epoch!r} for parameter "
                        f"'epoch'") from e
            try:
                return FieldOptions(type=FieldType.TIMESTAMP, **kw)
            except ValueError as e:
                # reference message shape (defs_date_functions):
                # invalid value 'x' for parameter 'timeunit'
                raise SQLError(
                    f"invalid value {cd.time_unit!r} for parameter "
                    "'timeunit'") from e
        if t == "bool":
            return FieldOptions(type=FieldType.BOOL)
        if t == "id":
            return FieldOptions(type=FieldType.MUTEX)
        if t == "string":
            return FieldOptions(type=FieldType.MUTEX, keys=True)
        if t == "idset":
            if cd.time_quantum:
                return FieldOptions(
                    type=FieldType.TIME,
                    time_quantum=TimeQuantum(cd.time_quantum))
            return FieldOptions(type=FieldType.SET)
        if t == "stringset":
            if cd.time_quantum:
                return FieldOptions(
                    type=FieldType.TIME,
                    time_quantum=TimeQuantum(cd.time_quantum),
                    keys=True)
            return FieldOptions(type=FieldType.SET, keys=True)
        raise SQLError(f"unknown column type {t!r}")

    def drop_table(self, stmt: ast.DropTable) -> SQLResult:
        eng = self.eng
        if eng.holder.index(stmt.name) is None and not stmt.if_exists:
            raise SQLError(f"table not found: {stmt.name}")
        eng.holder.delete_index(stmt.name)
        eng.holder.save_schema()
        return SQLResult()

    def show_columns(self, stmt: ast.ShowColumns) -> SQLResult:
        """The reference's 14-column listing (defs_sql1 show
        columns); untracked audit fields are empty/epoch."""
        idx = self.eng._index(stmt.table)
        epoch = "1970-01-01T00:00:00Z"

        def row(name, typ, o=None):
            return (None, name, typ, epoch,
                    bool(o.keys) if o is not None else bool(idx.keys),
                    o.cache_type if o is not None else "",
                    o.cache_size if o is not None else 0,
                    o.scale if o is not None else 0,
                    o.min if o is not None else None,
                    o.max if o is not None else None,
                    (o.time_unit if o is not None
                     and typ == "timestamp" else ""),
                    0,
                    (str(o.time_quantum) if o is not None
                     and o.time_quantum else ""),
                    "")
        rows = [row("_id", "string" if idx.keys else "id")]
        rows += [row(f.name, sql_type_of(f), f.options)
                 for f in declared_fields(idx)]
        return SQLResult(
            schema=[("_id", "string"), ("name", "string"),
                    ("type", "string"), ("created_at", "timestamp"),
                    ("keys", "bool"), ("cache_type", "string"),
                    ("cache_size", "int"), ("scale", "int"),
                    ("min", "int"), ("max", "int"),
                    ("timeunit", "string"), ("epoch", "int"),
                    ("timequantum", "string"), ("ttl", "string")],
            rows=rows)

    def show_create_table(self, stmt: ast.ShowCreateTable) -> SQLResult:
        """Canonical DDL round-trip: the emitted statement re-parses to
        an equivalent table (sql3's SHOW CREATE TABLE)."""
        idx = self.eng._index(stmt.table)
        defs = [f"_id {'string' if idx.keys else 'id'}"]
        for f in declared_fields(idx):
            t = sql_type_of(f)
            d = f"{f.name} {t}"
            o = f.options
            if t == "decimal" and o.scale:
                d += f"({o.scale})"
            if t == "int":
                if o.min is not None:
                    d += f" min {o.min}"
                if o.max is not None:
                    d += f" max {o.max}"
            if o.type == FieldType.TIME and o.time_quantum:
                d += f" timequantum '{o.time_quantum}'"
            defs.append(d)
        ddl = f"CREATE TABLE {idx.name} ({', '.join(defs)})"
        return SQLResult(schema=[("ddl", "string")], rows=[(ddl,)])

    def alter_table(self, stmt: ast.AlterTable) -> SQLResult:
        """ALTER TABLE ADD/DROP/RENAME COLUMN (sql3/planner/
        compilealtertable.go)."""
        eng = self.eng
        idx = eng._index(stmt.table)
        if stmt.op == "add":
            cd = stmt.column
            if cd.name == "_id":
                raise SQLError("cannot add _id")
            if idx.field(cd.name) is not None:
                raise SQLError(f"column already exists: {cd.name}")
            idx.create_field(cd.name, self.field_options(cd))
        elif stmt.op == "drop":
            if stmt.name == "_id":
                raise SQLError("cannot drop _id")
            if idx.field(stmt.name) is None:
                raise SQLError(f"column not found: {stmt.name}")
            idx.delete_field(stmt.name)
        else:  # rename
            if "_id" in (stmt.name, stmt.new_name):
                raise SQLError("cannot rename _id")
            try:
                idx.rename_field(stmt.name, stmt.new_name)
            except ValueError as e:
                raise SQLError(str(e)) from e
        eng.holder.save_schema()
        return SQLResult()

    def copy(self, stmt: ast.Copy) -> SQLResult:
        """COPY src TO dst (sql3 copy statement, defs_copy.go):
        Index.clone_to owns the deep copy; a mid-copy failure never
        strands a half-built table."""
        eng = self.eng
        if stmt.src in eng._views:
            raise SQLError("COPY supports tables, not views")
        src = eng.holder.index(stmt.src)
        if src is None:
            raise SQLError(f"table or view {stmt.src!r} not found")
        if stmt.dst in eng._views or \
                eng.holder.index(stmt.dst) is not None:
            raise SQLError(f"table or view {stmt.dst!r} already exists")
        dst = eng.holder.create_index(stmt.dst, keys=src.keys)
        try:
            src.clone_to(dst)
        except Exception:
            eng.holder.delete_index(stmt.dst)
            raise
        eng.holder.save_schema()
        return SQLResult()

    # -- DML ------------------------------------------------------------

    def insert(self, stmt: ast.Insert) -> SQLResult:
        eng = self.eng
        idx = eng._index(stmt.table)
        if stmt.columns is None:
            # bare INSERT INTO t VALUES: positional over _id + fields
            # in DECLARATION order (sql3 insert without a column
            # list) — fields dict preserves CREATE TABLE order
            from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
            stmt.columns = ["_id"] + [n for n in idx.fields
                                      if n != EXISTENCE_FIELD]
            for row in stmt.rows:
                if len(row) != len(stmt.columns):
                    raise SQLError(
                        "mismatch in the count of expressions and "
                        "target columns")
        if "_id" not in stmt.columns:
            raise SQLError("INSERT requires an _id column")
        if len(stmt.columns) == 1:
            # defs_inserts insertTest_11
            raise SQLError("insert column list must have at least "
                           "one non '_id' column specified")
        id_pos = stmt.columns.index("_id")
        fields = []
        for c in stmt.columns:
            if c == "_id":
                fields.append(None)
                continue
            f = idx.field(c)
            if f is None:
                raise SQLError(f"column not found: {c}")
            fields.append(f)
        for row_no, row in enumerate(stmt.rows, 1):
            self.apply_record(idx, fields, row, id_pos, stmt.replace,
                              row_no=row_no)
        return SQLResult()

    def apply_record(self, idx, fields, row, id_pos, replace,
                     row_no: int = 1):
        """Write one record's values (shared by INSERT / BULK
        INSERT)."""
        eng = self.eng
        # min/max constraint enforcement (defs_inserts: inserting a
        # value outside the declared int bounds is an error, not a
        # clamp)
        from decimal import Decimal
        for f, v in zip(fields, row):
            if f is None or v is None:
                continue
            o = f.options
            if o.type in (FieldType.INT, FieldType.DECIMAL) and \
                    isinstance(v, (int, float, Decimal, str)) and \
                    not isinstance(v, bool):
                try:
                    dv = Decimal(str(v))
                except ArithmeticError:
                    continue  # typed-value errors surface on write
                if (o.min is not None and dv < o.min) or \
                        (o.max is not None and dv > o.max):
                    shown = dv.normalize()
                    if shown == shown.to_integral_value():
                        shown = shown.quantize(Decimal(1))
                    raise SQLError(
                        f"inserting value into column '{f.name}', "
                        f"row {row_no}, value '{shown}' out of range")
        col = eng._col_id(idx, row[id_pos])

        def clear_field(f):
            """Drop every stored value a field holds for this
            record."""
            from pilosa_tpu_torch.ops import bitmap as bm
            shard, sc = divmod(col, idx.width)
            mask = bm.from_columns([sc], idx.width)
            for v in f.views.values():
                frag = v.fragment(shard)
                if frag is not None:
                    frag.clear_columns(mask)

        if replace:
            # full-record replace: drop existing values first
            for f in idx.fields.values():
                clear_field(f)
        for f, v in zip(fields, row):
            if f is None:
                continue
            t = f.options.type
            if v is None:
                # an EXPLICIT null in the tuple clears bool/mutex
                # state for the record (the reference's INSERT goes
                # through the batcher's clear-then-set mutex path;
                # defs_bool select-all2: re-inserting (2, null) over
                # (2, true) reads back NULL)
                if not replace and t in (FieldType.BOOL,
                                         FieldType.MUTEX):
                    clear_field(f)
                continue
            if t.is_bsi:
                f.set_value(col, v)
            elif t == FieldType.BOOL:
                f.set_bit(1 if v else 0, col)
            else:
                ts = None
                if t == FieldType.TIME and isinstance(v, list) and \
                        len(v) == 2 and \
                        isinstance(v[0], (str, int)) and \
                        not isinstance(v[0], bool) and \
                        isinstance(v[1], list):
                    # quantum tuple ('<timestamp>', (vals...)) —
                    # opinsert.go:275's 2-member time-quantum form
                    from pilosa_tpu_torch.models import timeq
                    try:
                        ts = timeq.parse_time(v[0])
                    except ValueError:
                        raise SQLError(
                            f"column {f.name}: bad quantum timestamp "
                            f"{v[0]!r}")
                    v = v[1]
                elif t == FieldType.TIME and not isinstance(v, list):
                    # setq columns take a set or a {ts, [set]} pair,
                    # never a bare scalar (defs_timequantum
                    # timeQuantumTest_8)
                    kind = ("string" if isinstance(v, str) else
                            "bool" if isinstance(v, bool) else "int")
                    setk = ("stringsetq" if f.options.keys
                            else "idsetq")
                    raise SQLError(
                        f"an expression of type '{kind}' cannot be "
                        f"assigned to type '{setk}'")
                vals = v if isinstance(v, list) else [v]
                if t == FieldType.MUTEX and len(vals) > 1:
                    raise SQLError(
                        f"column {f.name} accepts a single value")
                for item in vals:
                    f.set_bit(self.row_id(f, item, create=True), col,
                              timestamp=ts)
        idx.mark_columns_exist([col])

    def bulk_insert(self, stmt: ast.BulkInsert) -> SQLResult:
        """BULK INSERT: stream a CSV (file or inline payload) through
        the same record-apply path as INSERT — the COPY/BULK INSERT
        ingest statement (sql3/parser bulk insert; defs_bulkinsert.go
        MAP/TRANSFORM shapes).  Without MAP, columns map positionally
        and empty cells are NULL; idset/stringset cells may hold
        ';'-separated lists.  With MAP, sources convert per the MAP
        type and TRANSFORM expressions (@N) produce column values,
        checked for assignment compatibility before any write."""
        idx = self.eng._index(stmt.table)
        fields, id_pos = self.bulk_fields(idx, stmt.columns)
        self.bulk_typecheck(stmt, idx, fields)
        for row in self.iter_bulk_rows(stmt, idx, fields):
            self.apply_record(idx, fields, row, id_pos, replace=False)
        # like INSERT, the reference returns no result set
        # (defs_bulkinsert.go ExpHdrs empty)
        return SQLResult()

    _BULK_ASSIGN_OK = {
        "id": {"id", "int"},
        "int": {"int"},
        "decimal": {"decimal", "int"},
        "string": {"string"},
        "bool": {"bool"},
        "timestamp": {"timestamp", "string", "int"},
        "idset": {"idset", "idsetq", "id", "int"},
        "stringset": {"stringset", "stringsetq", "string"},
    }

    def bulk_typecheck(self, stmt, idx, fields):
        """MAP/TRANSFORM assignment compatibility (the reference's
        bulk-insert analyze step; defs_bulkinsert.go expects e.g.
        "an expression of type 'string' cannot be assigned to type
        'int'")."""
        if stmt.maps is None:
            if stmt.transforms is not None:
                raise SQLError("TRANSFORM requires a MAP clause")
            return
        from pilosa_tpu_torch.sql.typecheck import (
            TInfo, TypeChecker, field_tinfo)

        def map_tinfo(i):
            _src, kind, scale = stmt.maps[i]
            return TInfo(kind,
                         scale=scale if scale is not None else 0)

        if stmt.transforms is not None:
            if len(stmt.transforms) != len(stmt.columns):
                raise SQLError(
                    f"mismatch in the count of expressions: "
                    f"{len(stmt.transforms)} transforms for "
                    f"{len(stmt.columns)} columns")
            srcs = []
            for e in stmt.transforms:
                if isinstance(e, ast.Var) and e.name.isdigit():
                    n = int(e.name)
                    if n >= len(stmt.maps):
                        raise SQLError(f"unknown map reference @{n}")
                    srcs.append(map_tinfo(n))
                elif isinstance(e, ast.Lit):
                    srcs.append(TypeChecker(self.eng, idx)._lit(e.value))
                else:
                    srcs.append(TInfo("any"))
        else:
            if len(stmt.maps) != len(stmt.columns):
                raise SQLError(
                    f"mismatch in the count of expressions: "
                    f"{len(stmt.maps)} map values for "
                    f"{len(stmt.columns)} columns")
            srcs = [map_tinfo(i) for i in range(len(stmt.maps))]
        for ci, (f, src) in enumerate(zip(fields, srcs)):
            if f is None:
                dst = TInfo("string" if idx.keys else "id")
            else:
                dst = field_tinfo(f)
            if src.kind in ("any", "null"):
                continue
            ok = self._BULK_ASSIGN_OK.get(dst.kind, {dst.kind})
            if src.kind not in ok:
                raise SQLError(
                    f"an expression of type '{src.render()}' cannot "
                    f"be assigned to type '{dst.render()}'")

    def bulk_fields(self, idx, columns):
        """Resolve BULK INSERT target fields (+ the _id position)."""
        if "_id" not in columns:
            raise SQLError("BULK INSERT requires an _id column")
        id_pos = columns.index("_id")
        fields = []
        for c in columns:
            if c == "_id":
                fields.append(None)
                continue
            f = idx.field(c)
            if f is None:
                raise SQLError(f"column not found: {c}")
            fields.append(f)
        return fields, id_pos

    def iter_bulk_rows(self, stmt, idx, fields):
        """Yield type-converted rows from the CSV source — shared by
        the local apply path and the DAX routed path."""
        import csv
        import io

        id_pos = stmt.columns.index("_id")

        def convert(f, text: str):
            if text == "":
                return None
            if f is None:  # _id
                return text if idx.keys else int(text)
            t = f.options.type
            if t == FieldType.INT or t == FieldType.TIMESTAMP:
                return int(text) if t == FieldType.INT else text
            if t == FieldType.DECIMAL:
                from decimal import Decimal
                return Decimal(text)
            if t == FieldType.BOOL:
                return text.strip().lower() in ("1", "true", "t", "yes")
            if ";" in text:
                items = text.split(";")
                return [int(i) if not f.options.keys else i
                        for i in items]
            return text if f.options.keys else int(text)

        def convert_map(text: str, kind: str, scale):
            if text == "":
                return None
            if kind in ("id", "int"):
                return int(text)
            if kind == "decimal":
                from decimal import Decimal
                d = Decimal(text)
                if scale is not None:
                    # DECIMAL(n) MAP type: quantize to the declared
                    # scale (half-even, like the storage layer)
                    d = d.quantize(Decimal(1).scaleb(-scale))
                return d
            if kind == "bool":
                return text.strip().lower() in ("1", "true", "t",
                                                "yes")
            if kind in ("idset", "idsetq"):
                return [int(i) for i in text.split(";")]
            if kind in ("stringset", "stringsetq"):
                return text.split(";")
            return text  # string / timestamp pass through

        if stmt.transforms is not None:
            from pilosa_tpu_torch.sql.funcs import Evaluator
            transform_ev = Evaluator(udfs=self.eng._udf_callables())

        def mapped_row(raw, row_no):
            vals = []
            for src, kind, scale in stmt.maps:
                if not isinstance(src, int):
                    raise SQLError(
                        "MAP path sources require a record format "
                        "(CSV maps by position)")
                if src >= len(raw):
                    if stmt.allow_missing:
                        vals.append(None)
                        continue
                    raise SQLError(
                        f"CSV row {row_no} has {len(raw)} fields, "
                        f"map references position {src}")
                try:
                    vals.append(convert_map(raw[src].strip(), kind,
                                            scale))
                except (ValueError, ArithmeticError) as exc:
                    raise SQLError(f"CSV row {row_no}: bad value "
                                   f"({exc})")
            if stmt.transforms is None:
                return vals
            env = {f"@{i}": v for i, v in enumerate(vals)}
            return [transform_ev.eval(e, env)
                    for e in stmt.transforms]

        if stmt.input == "FILE":
            try:
                fh = open(stmt.path, newline="")
            except OSError as exc:
                raise SQLError(
                    f"BULK INSERT cannot read {stmt.path!r}: {exc}")
        else:
            fh = io.StringIO(stmt.payload or "")
        with fh:
            reader = csv.reader(fh)
            for i, raw in enumerate(reader):
                if i == 0 and stmt.header_row:
                    continue
                if not raw:
                    continue
                if stmt.maps is not None:
                    row = mapped_row(raw, i + 1)
                elif len(raw) != len(stmt.columns):
                    raise SQLError(
                        f"CSV row {i + 1} has {len(raw)} fields, "
                        f"expected {len(stmt.columns)}")
                else:
                    try:
                        row = [convert(f, cell.strip())
                               for f, cell in zip(fields, raw)]
                    except (ValueError, ArithmeticError) as exc:
                        raise SQLError(
                            f"CSV row {i + 1}: bad value ({exc})")
                if row[id_pos] is None:
                    raise SQLError(f"CSV row {i + 1} has empty _id")
                yield row

    def row_id(self, f, v, create=False):
        if isinstance(v, str):
            tr = f.row_translator
            if tr is None:
                raise SQLError(
                    f"column {f.name} holds ids, got string {v!r}")
            if create:
                return tr.create_keys(v)[v]
            return tr.find_keys(v).get(v)
        if f.options.keys:
            raise SQLError(f"column {f.name} uses keys; got id {v!r}")
        return int(v)

    def delete(self, stmt: ast.Delete) -> SQLResult:
        eng = self.eng
        idx = eng._index(stmt.table)
        # qualified WHERE columns must name the target table or its
        # alias — a bogus qualifier must not silently resolve
        allowed = {stmt.table, stmt.alias} - {None}

        def walk(e):
            if isinstance(e, ast.Col):
                if e.table is not None and e.table not in allowed:
                    raise SQLError(f"unknown table {e.table!r}")
                return
            if e is None or isinstance(e, (str, int, float, bool)):
                return
            for attr in ("left", "right", "expr", "col", "arg",
                         "lo", "hi", "args", "items"):
                sub = getattr(e, attr, None)
                if isinstance(sub, (list, tuple)):
                    for s in sub:
                        walk(s)
                elif sub is not None:
                    walk(sub)
        walk(stmt.where)
        filt = eng.wherec.compile_where(idx, stmt.where)
        eng.executor._execute_call(
            idx, Call("Delete", children=[filt]), None)
        return SQLResult()

    # -- UDFs -----------------------------------------------------------

    def create_function(self, stmt: ast.CreateFunction) -> SQLResult:
        from pilosa_tpu_torch.sql.funcs import _ARITY
        eng = self.eng
        name = stmt.name.upper()
        if name in _ARITY:
            raise SQLError(
                f"cannot redefine built-in function {stmt.name}")
        if name in eng._functions:
            if stmt.if_not_exists:
                return SQLResult()
            raise SQLError(f"function already exists: {stmt.name}")
        # body validation: parameters only (no table columns), calls
        # only to builtins or PREVIOUSLY defined functions — combined
        # with the captured-snapshot binding in engine._make_udf, a
        # body can never reach itself
        params = {p for p, _t in stmt.params}
        if len(params) != len(stmt.params):
            raise SQLError("duplicate parameter name")
        captured: dict[str, tuple] = {}

        def check(e):
            if isinstance(e, ast.Col):
                raise SQLError(
                    "function bodies may reference only parameters")
            if isinstance(e, ast.Var) and e.name not in params:
                raise SQLError(f"unknown parameter @{e.name}")
            if isinstance(e, ast.Func):
                if e.name in eng._functions:
                    captured[e.name] = eng._functions[e.name]
                elif e.name not in _ARITY:
                    raise SQLError(f"unknown function {e.name}")
                for x in e.args:
                    check(x)
            for attr in ("left", "right", "expr", "col", "lo", "hi"):
                sub = getattr(e, attr, None)
                if sub is not None and not isinstance(sub, (str, int)):
                    check(sub)
        check(stmt.body)
        eng._functions[name] = (stmt, captured)
        return SQLResult()
