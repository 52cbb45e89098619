"""Recursive-descent SQL parser (sql3/parser/parser.go subset).

Statements: CREATE TABLE / DROP TABLE / SHOW TABLES / SHOW COLUMNS /
INSERT [OR REPLACE] / DELETE / SELECT with WHERE, GROUP BY, HAVING,
ORDER BY, LIMIT/OFFSET, DISTINCT, and aggregate projections.
"""

from __future__ import annotations

from decimal import Decimal

from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError, Token, tokenize

_TYPES = {"id", "string", "int", "decimal", "timestamp", "bool", "idset",
          "stringset"}


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    # -- token plumbing -------------------------------------------------

    def peek(self, ahead=0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind, value=None) -> Token | None:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SQLError(
                f"expected {value or kind} at {got.pos}, got {got.value!r}")
        return t

    def int_tok(self, what: str) -> int:
        """An integer literal (TOP/LIMIT/OFFSET counts): a fractional
        number is a SQL error, not a raw ValueError."""
        t = self.expect("number")
        try:
            return int(t.value)
        except ValueError:
            raise SQLError(f"{what} requires an integer, got {t.value!r}")

    def kw(self, word) -> Token | None:
        return self.accept("keyword", word)

    def expect_kw(self, word) -> Token:
        return self.expect("keyword", word)

    def ctx_kw(self, word) -> Token | None:
        """Contextual keyword: lexes as an ident (so it stays usable
        as a column/table name) but acts as a keyword here."""
        t = self.peek()
        if t.kind == "ident" and t.value.lower() == word:
            return self.next()
        return None

    # -- statements -----------------------------------------------------

    def parse(self):
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.statement())
            self.accept("op", ";")
        if not stmts:
            raise SQLError("empty statement")
        return stmts

    def statement(self):
        t = self.peek()
        if t.kind == "ident" and t.value.lower() == "copy":
            return self.copy_stmt()
        if t.kind != "keyword":
            raise SQLError(f"unexpected {t.value!r} at {t.pos}")
        if t.value == "create":
            return self.create_table()
        if t.value == "drop":
            return self.drop_table()
        if t.value == "show":
            return self.show()
        if t.value == "bulk":
            return self.bulk_insert()
        if t.value in ("insert", "replace"):
            return self.insert()
        if t.value == "delete":
            return self.delete()
        if t.value == "select":
            return self.select()
        if t.value == "alter":
            return self.alter_table()
        if t.value == "explain":
            self.next()
            return ast.Explain(self.statement())
        raise SQLError(f"unsupported statement {t.value!r}")

    def create_table(self):
        self.expect_kw("create")
        if self.ctx_kw("view"):
            return self._create_view()
        if self.ctx_kw("function"):
            return self._create_function()
        self.expect_kw("table")
        if_not_exists = False
        if self.kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.expect("ident").value
        self.expect("op", "(")
        cols = []
        keys = False
        while True:
            cd = self.column_def()
            if cd.name == "_id":
                keys = cd.type == "string"
            cols.append(cd)
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        # COMMENT 'text' table option (sql3 tableOption): parsed,
        # stored nowhere — the engine keeps no table comments
        if self.ctx_kw("comment"):
            self.expect("string")
        return ast.CreateTable(name, cols, keys=keys,
                               if_not_exists=if_not_exists)

    def column_def(self) -> ast.ColumnDef:
        cname = self.expect("ident").value
        ctype = self.next().value.lower()
        if ctype not in _TYPES:
            raise SQLError(f"unknown column type {ctype!r}")
        cd = ast.ColumnDef(cname, ctype)
        if ctype == "decimal" and self.accept("op", "("):
            cd.scale = int(self.expect("number").value)
            self.expect("op", ")")
        # column constraints subset: min/max for int ("min"/"max"
        # lex as keywords, "timequantum"/"timeunit"/"epoch" as idents)
        while self.peek().kind in ("ident", "keyword") and \
                self.peek().value.lower() in (
                    "min", "max", "timequantum", "timeunit", "epoch"):
            opt = self.next().value.lower()
            if opt == "timequantum":
                cd.time_quantum = self.expect("string").value
            elif opt == "timeunit":
                cd.time_unit = self.expect("string").value
            elif opt == "epoch":
                cd.epoch = self.expect("string").value
            else:
                neg = self.accept("op", "-") is not None
                tok = self.expect("number").value
                v = (Decimal(tok) if "." in tok else int(tok))
                setattr(cd, opt, -v if neg else v)
        if cd.min is not None and cd.max is not None and \
                cd.min > cd.max:
            raise SQLError(f"{ctype} field min cannot be greater "
                           "than max")
        return cd

    def copy_stmt(self):
        self.next()  # copy (contextual)
        src = self.expect("ident").value
        if not self.ctx_kw("to"):
            raise SQLError("expected TO in COPY")
        return ast.Copy(src, self.expect("ident").value)

    def alter_table(self):
        """ALTER TABLE t ADD [COLUMN] def | DROP [COLUMN] name |
        RENAME [COLUMN] old TO new (sql3/parser AlterTableStatement);
        ALTER VIEW name AS SELECT ..."""
        self.expect_kw("alter")
        if self.ctx_kw("view"):
            name = self.expect("ident").value
            self.expect_kw("as")
            return ast.AlterView(name, self.select())
        self.expect_kw("table")
        table = self.expect("ident").value
        if self.kw("add"):
            self.kw("column")
            return ast.AlterTable(table, "add", column=self.column_def())
        if self.kw("drop"):
            self.kw("column")
            return ast.AlterTable(table, "drop",
                                  name=self.expect("ident").value)
        if self.ctx_kw("rename"):
            self.kw("column")
            old = self.expect("ident").value
            if not self.ctx_kw("to"):
                raise SQLError("expected TO in RENAME COLUMN")
            return ast.AlterTable(table, "rename", name=old,
                                  new_name=self.expect("ident").value)
        raise SQLError("expected ADD, DROP or RENAME after ALTER TABLE")

    def _create_view(self):
        if_not_exists = False
        if self.kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.expect("ident").value
        self.expect_kw("as")
        sel = self.select()
        return ast.CreateView(name, sel, if_not_exists=if_not_exists)

    def _create_function(self):
        """CREATE FUNCTION [IF NOT EXISTS] name(@p type, ...)
        RETURNS type AS (expr) — sql3/parser CreateFunctionStatement
        with a scalar-expression body."""
        if_not_exists = False
        if self.kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.expect("ident").value
        self.expect("op", "(")
        params = []
        if not self.accept("op", ")"):
            while True:
                pname = self.expect("var").value
                ptype = self.next().value.lower()
                if ptype not in _TYPES:
                    raise SQLError(f"unknown parameter type {ptype!r}")
                params.append((pname, ptype))
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        if not self.ctx_kw("returns"):
            raise SQLError("expected RETURNS in CREATE FUNCTION")
        rtype = self.next().value.lower()
        if rtype not in _TYPES:
            raise SQLError(f"unknown return type {rtype!r}")
        self.expect_kw("as")
        self.expect("op", "(")
        body = self.expr()
        self.expect("op", ")")
        return ast.CreateFunction(name, params, rtype, body,
                                  if_not_exists=if_not_exists)

    def drop_table(self):
        self.expect_kw("drop")
        if self.ctx_kw("function"):
            if_exists = False
            if self.kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropFunction(self.expect("ident").value,
                                    if_exists=if_exists)
        if self.ctx_kw("view"):
            if_exists = False
            if self.kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropView(self.expect("ident").value,
                                if_exists=if_exists)
        self.expect_kw("table")
        if_exists = False
        if self.kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropTable(self.expect("ident").value, if_exists=if_exists)

    def show(self):
        self.expect_kw("show")
        if self.kw("tables"):
            return ast.ShowTables()
        if self.ctx_kw("views"):
            return ast.ShowViews()
        if self.kw("columns"):
            self.expect_kw("from")
            return ast.ShowColumns(self.expect("ident").value)
        if self.kw("create"):
            self.expect_kw("table")
            return ast.ShowCreateTable(self.expect("ident").value)
        if self.ctx_kw("functions"):
            return ast.ShowFunctions()
        if self.kw("databases"):
            return ast.ShowDatabases()
        raise SQLError(
            "expected TABLES, VIEWS, COLUMNS or CREATE TABLE after SHOW")

    def insert(self):
        replace = False
        if self.kw("replace"):
            self.expect_kw("into")
            replace = True
        else:
            self.expect_kw("insert")
            if self.kw("or"):
                self.expect_kw("replace")
                replace = True
            self.expect_kw("into")
        table = self.expect("ident").value
        # the column list is optional: INSERT INTO t VALUES (...) maps
        # positionally to _id + fields in schema order
        # (defs_delete.go's bare inserts)
        cols = None
        if self.accept("op", "("):
            cols = []
            while True:
                cols.append(self.expect("ident").value)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        self.expect_kw("values")
        rows = []
        while True:
            self.expect("op", "(")
            row = []
            while True:
                row.append(self._insert_value())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            if cols is not None and len(row) != len(cols):
                raise SQLError("mismatch in the count of expressions "
                               "and target columns")
            rows.append(row)
            if not self.accept("op", ","):
                break
        return ast.Insert(table, cols, rows, replace=replace)

    def _insert_value(self):
        """One VALUES cell: a literal, or a constant scalar
        expression folded at parse time (defs_inserts: 40*10,
        'foo' || 'bar', 1 > 2)."""
        # fast path: plain literal / tuple / bracket-set / negative
        t, t1 = self.peek(), self.peek(1)
        terminator = t1.kind == "op" and t1.value in (",", ")")
        if terminator and (
                t.kind in ("number", "string") or
                (t.kind == "keyword"
                 and t.value in ("true", "false", "null"))):
            return self.literal_value()
        if t.kind == "op" and t.value in ("(", "[", "{"):
            return self.literal_value()
        if t.kind == "op" and t.value == "-" and \
                t1.kind == "number":
            return self.literal_value()
        if t.kind == "ident" and t.value.lower() in (
                "current_timestamp", "current_date"):
            return self.literal_value()
        # constant expression: parse and evaluate with no row context
        e = self.expr()
        if isinstance(e, ast.Lit):
            return e.value
        from pilosa_tpu_torch.sql.funcs import Evaluator
        return Evaluator().eval(e, {})

    _MAP_TYPES = {"id", "string", "int", "decimal", "bool",
                  "timestamp", "stringset", "idset", "idsetq",
                  "stringsetq"}

    def bulk_insert(self):
        """BULK INSERT INTO t (cols...) [MAP (src TYPE, ...)]
        [TRANSFORM (@N-expr, ...)] FROM '<src>'|x'<rows>' WITH
        [BATCHSIZE n] FORMAT 'CSV' INPUT 'FILE'|'STREAM'
        [HEADER_ROW] [ALLOW_MISSING_VALUES] (sql3/parser bulk-insert
        grammar; defs_bulkinsert.go shapes).  Without MAP, columns map
        positionally to CSV fields; MAP sources are CSV positions,
        TRANSFORM expressions reference them as @N."""
        self.expect_kw("bulk")
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.expect("ident").value
        cols = []
        self.expect("op", "(")
        while True:
            cols.append(self.expect("ident").value)
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        stmt = ast.BulkInsert(table, cols)
        if self.ctx_kw("map"):
            stmt.maps = []
            self.expect("op", "(")
            while True:
                t = self.next()
                if t.kind == "number" and "." not in t.value:
                    src = int(t.value)
                elif t.kind == "string":
                    src = t.value
                else:
                    raise SQLError(
                        "MAP source must be a position or path")
                ktok = self.next()
                kind = ktok.value.lower()
                if kind not in self._MAP_TYPES:
                    raise SQLError(f"unknown MAP type {ktok.value!r}")
                scale = None
                if kind == "decimal" and self.accept("op", "("):
                    scale = int(self.expect("number").value)
                    self.expect("op", ")")
                stmt.maps.append((src, kind, scale))
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        if self.ctx_kw("transform"):
            stmt.transforms = []
            self.expect("op", "(")
            while True:
                stmt.transforms.append(self.expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        self.expect_kw("from")
        if self.peek().kind == "ident" and \
                self.peek().value.lower() == "x" and \
                self.peek(1).kind == "string":
            # x'...' inline blob (the reference's STREAM payload form)
            self.next()
        src = self.expect("string").value
        self.expect_kw("with")
        fmt = inp = None
        while True:
            if self.ctx_kw("format"):
                fmt = self.expect("string").value.upper()
            elif self.ctx_kw("input"):
                inp = self.expect("string").value.upper()
            elif self.ctx_kw("header_row"):
                stmt.header_row = True
            elif self.ctx_kw("batchsize"):
                stmt.batch_size = int(self.expect("number").value)
            elif self.ctx_kw("allow_missing_values"):
                stmt.allow_missing = True
            else:
                break
        if fmt != "CSV":
            raise SQLError("BULK INSERT supports FORMAT 'CSV'")
        if inp not in ("FILE", "STREAM"):
            raise SQLError("BULK INSERT supports INPUT 'FILE'|'STREAM'")
        stmt.format, stmt.input = fmt, inp
        if inp == "FILE":
            stmt.path = src
        else:
            stmt.payload = src
        return stmt

    def delete(self):
        """DELETE FROM t [[AS] alias] [WHERE ...] (sql3/parser
        parseDeleteStatement + parseQualifiedTableName; DELETE joins
        are unsupported there too — defs_delete.go:121 keeps its join
        case disabled)."""
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.expect("ident").value
        alias = self._table_alias()
        if (self.peek().kind == "keyword"
                and self.peek().value in ("inner", "join")):
            raise SQLError("joins are not supported in DELETE")
        where = None
        if self.kw("where"):
            where = self.expr()
        return ast.Delete(table, where, alias=alias)

    def select(self):
        self.expect_kw("select")
        sel = ast.Select()
        # TOP(n) — only TOP immediately followed by '(' is the clause
        # (sql3/parser/parser.go:2376)
        if self.peek().kind in ("keyword", "ident") and \
                self.peek().value.lower() == "top" and \
                self.peek(1).kind == "op" and self.peek(1).value == "(":
            self.next()
            self.expect("op", "(")
            sel.top = self.int_tok("TOP")
            self.expect("op", ")")
        sel.distinct = bool(self.kw("distinct"))
        while True:
            if self.accept("op", "*"):
                sel.items.append(ast.SelectItem(ast.Col("*")))
            else:
                e = self.expr()
                alias = None
                if self.kw("as"):
                    alias = self.next().value
                sel.items.append(ast.SelectItem(e, alias))
            if not self.accept("op", ","):
                break
        # FROM is optional (sql3 supports constant selects, e.g.
        # `select cast(1 as bool)`); the tail clauses still parse so
        # `SELECT 1 LIMIT 1` works and `SELECT 1 WHERE ...` errors in
        # the engine, not as a bogus "unsupported statement"
        has_from = bool(self.kw("from"))
        if has_from and self.peek().kind == "op" and \
                self.peek().value == "(":
            # FROM (SELECT ...) [AS] alias — derived table
            self.next()
            if not (self.peek().kind == "keyword"
                    and self.peek().value == "select"):
                raise SQLError("expected SELECT in FROM subquery")
            sel.from_select = self.select()
            self.expect("op", ")")
            sel.table_alias = self._table_alias()
        elif has_from:
            sel.table = self.expect("ident").value
            sel.table_alias = self._table_alias()
        while has_from:
            outer = False

            def _at_ctx_join(word: str) -> bool:
                # LEFT/FULL/RIGHT [OUTER] JOIN with the qualifier as a
                # contextual keyword (still a valid identifier
                # elsewhere)
                t0, t1, t2 = self.peek(), self.peek(1), self.peek(2)
                if not (t0.kind == "ident" and t0.value.lower() == word):
                    return False
                if t1.kind == "keyword" and t1.value == "join":
                    return True
                return (t1.kind == "ident" and t1.value.lower() == "outer"
                        and t2.kind == "keyword" and t2.value == "join")

            if self.accept("op", ","):
                # comma join: FROM a, b [, (SELECT ...) x] — a cross
                # product; the join condition lives in WHERE
                # (sql3/parser source lists; defs_join.go commajoin)
                jt, sub = self._join_source()
                sel.joins.append(ast.Join(jt, None, None,
                                          alias=self._table_alias(),
                                          subquery=sub))
                continue
            if self.kw("inner"):
                self.expect_kw("join")
            elif _at_ctx_join("left"):
                self.next()  # left
                self.ctx_kw("outer")
                self.expect_kw("join")
                outer = True
            elif _at_ctx_join("full") or _at_ctx_join("right"):
                # parsed so the analysis error matches defs_join.go
                kind = self.next().value.upper()
                raise SQLError(f"{kind} join types are not supported")
            elif not self.kw("join"):
                break
            jt, sub = self._join_source()
            alias = self._table_alias()
            self.expect_kw("on")
            cond = self.expr()
            if not (isinstance(cond, ast.BinOp) and cond.op == "="
                    and isinstance(cond.left, ast.Col)
                    and isinstance(cond.right, ast.Col)):
                raise SQLError(
                    "JOIN ON must be column = column equality")
            sel.joins.append(ast.Join(jt, cond.left, cond.right,
                                      outer=outer, alias=alias,
                                      subquery=sub))
        if has_from and self.kw("with"):
            # WITH (hint(args), ...) query hints (sql3 tableOption
            # hints; only flatten is known)
            self.expect("op", "(")
            while True:
                hname = self.expect("ident").value
                self.expect("op", "(")
                args = []
                if not self.accept("op", ")"):
                    while True:
                        args.append(self.expect("ident").value)
                        if not self.accept("op", ","):
                            break
                    self.expect("op", ")")
                if hname.lower() != "flatten":
                    raise SQLError(
                        f"unknown query hint '{hname}'")
                if len(args) != 1:
                    raise SQLError(
                        "query hint 'flatten' expected 1 "
                        "parameter(s) (column name), got "
                        f"{len(args)} parameter(s)")
                sel.flatten.append(args[0])
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        if self.kw("where"):
            sel.where = self.expr()
        if self.kw("group"):
            self.expect_kw("by")
            while True:
                g = self.expect("ident").value
                if self.accept("op", "."):
                    g += "." + self.expect("ident").value
                sel.group_by.append(g)
                if not self.accept("op", ","):
                    break
        if self.kw("having"):
            sel.having = self.expr()
        if self.kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                desc = False
                if self.kw("desc"):
                    desc = True
                elif self.kw("asc"):
                    pass
                sel.order_by.append(ast.OrderBy(e, desc))
                if not self.accept("op", ","):
                    break
        if self.kw("limit"):
            sel.limit = self.int_tok("LIMIT")
        if self.kw("offset"):
            sel.offset = self.int_tok("OFFSET")
        if sel.top is not None:
            # defs_top.go: TOP and LIMIT conflict; otherwise TOP(n)
            # behaves exactly as LIMIT n
            if sel.limit is not None:
                raise SQLError(
                    "TOP and LIMIT cannot be used at the same time")
            sel.limit = sel.top
        return sel

    # reserved words that must not be eaten as a bare table alias
    _NO_ALIAS = {"left", "outer", "full", "right", "cross", "copy"}

    def _join_source(self):
        """One join source: a table name, or (SELECT ...) derived
        table.  Returns (table_name, subselect) with exactly one
        set."""
        if self.peek().kind == "op" and self.peek().value == "(":
            self.next()
            if not (self.peek().kind == "keyword"
                    and self.peek().value == "select"):
                raise SQLError("expected SELECT in FROM subquery")
            sub = self.select()
            self.expect("op", ")")
            return None, sub
        return self.expect("ident").value, None

    def _table_alias(self) -> str | None:
        """Optional table alias: AS name or a bare identifier
        (sql3/parser tableOrSubquery aliases)."""
        if self.kw("as"):
            return self.expect("ident").value
        t = self.peek()
        if t.kind == "ident" and t.value.lower() not in self._NO_ALIAS:
            return self.next().value
        return None

    # -- expressions ----------------------------------------------------

    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.kw("or"):
            left = ast.BinOp("or", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.kw("and"):
            left = ast.BinOp("and", left, self.not_expr())
        return left

    def not_expr(self):
        if self.kw("not"):
            return ast.Not(self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        left = self.bit_expr()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">",
                                          ">="):
            op = self.next().value
            if op == "<>":
                op = "!="
            return ast.BinOp(op, left, self.bit_expr())
        if t.kind == "keyword":
            negated = False
            if t.value == "not":
                # col NOT IN / NOT LIKE / NOT BETWEEN
                nxt = self.peek(1)
                if nxt.kind == "keyword" and nxt.value in ("in", "like",
                                                           "between"):
                    self.next()
                    negated = True
                    t = self.peek()
            if self.kw("in"):
                self.expect("op", "(")
                if self.peek().kind == "keyword" and \
                        self.peek().value == "select":
                    sub = self.select()
                    self.expect("op", ")")
                    return ast.InSelect(left, sub, negated=negated)
                items = []
                while True:
                    items.append(self.literal_value())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                return ast.InList(left, items, negated=negated)
            if self.kw("like"):
                pat = self.expect("string").value
                node = ast.BinOp("like", left, ast.Lit(pat))
                return ast.Not(node) if negated else node
            if self.kw("between"):
                lo = self.add_expr()
                self.expect_kw("and")
                hi = self.add_expr()
                return ast.Between(left, lo, hi, negated=negated)
            if self.kw("is"):
                negated = bool(self.kw("not"))
                self.expect_kw("null")
                return ast.IsNull(left, negated=negated)
        return left

    def bit_expr(self):
        """<< >> & | — one level, left-assoc, binding tighter than
        comparison and looser than + - (the SQLite-style placement
        sql3/parser follows)."""
        left = self.add_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("<<", ">>", "&", "|"):
                op = self.next().value
                left = ast.BinOp(op, left, self.add_expr())
            else:
                return left

    def add_expr(self):
        """+ - and || (string concat) — the additive precedence level
        of sql3/parser's expression grammar."""
        left = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                op = self.next().value
                left = ast.BinOp(op, left, self.mul_expr())
            else:
                return left

    def mul_expr(self):
        left = self.unary_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                op = self.next().value
                left = ast.BinOp(op, left, self.unary_expr())
            else:
                return left

    def unary_expr(self):
        if self.accept("op", "-"):
            e = self.unary_expr()
            if isinstance(e, ast.Lit) and isinstance(e.value, (int, Decimal)):
                return ast.Lit(-e.value)
            return ast.BinOp("-", ast.Lit(0), e)
        if self.accept("op", "+"):
            # unary plus is the numeric identity: it still type-checks
            # (defs_unops: `select +i` -> 10 but `select +ts` errors
            # "operator '+' incompatible with type 'timestamp'")
            e = self.unary_expr()
            if isinstance(e, ast.Lit) and \
                    isinstance(e.value, (int, Decimal)) and \
                    not isinstance(e.value, bool):
                return e
            return ast.BinOp("+", ast.Lit(0), e)
        if self.accept("op", "!"):
            # bitwise complement, ints only (defs_unops: !10 -> -11)
            return ast.Func("BITNOT", [self.unary_expr()])
        return self.primary()

    def primary(self):
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().kind == "keyword" and \
                    self.peek().value == "select":
                sub = self.select()
                self.expect("op", ")")
                return ast.SubQuery(sub)
            e = self.expr()
            if self.accept("op", ","):
                # parenthesized tuple (set literal): every element must
                # be literal — (1, 2) / ('a', 'b') for SETCONTAINSANY etc.
                items = [self._lit_of(e)]
                while True:
                    items.append(self._lit_of(self.expr()))
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                return ast.Lit(items)
            self.expect("op", ")")
            return e
        if t.kind == "keyword" and t.value in ("count", "sum", "min", "max",
                                               "avg", "percentile", "var",
                                               "corr"):
            return self.aggregate()
        if t.kind == "number":
            return ast.Lit(self.literal_value())
        if t.kind == "string":
            return ast.Lit(self.next().value)
        if t.kind == "keyword" and t.value in ("true", "false", "null"):
            self.next()
            return ast.Lit({"true": True, "false": False,
                            "null": None}[t.value])
        if t.kind == "op" and t.value == "[":
            # bracket set literal as an expression ([1,2] IN lists,
            # SETCONTAINS args); elements must be literals
            return ast.Lit(self.literal_value())
        if t.kind == "var":
            return ast.Var(self.next().value)
        if t.kind == "ident" and t.value.lower() in (
                "current_timestamp", "current_date"):
            return ast.Lit(self.literal_value())
        if t.kind == "ident":
            name = self.next().value
            if self.peek().kind == "op" and self.peek().value == "(":
                return self.func_call(name)
            if self.accept("op", "."):
                if self.accept("op", "*"):
                    # qualified star u.* (defs_join
                    # join-select-start)
                    return ast.Col("*", table=name)
                return ast.Col(self.expect("ident").value, table=name)
            return ast.Col(name)
        raise SQLError(f"unexpected {t.value!r} at {t.pos}")

    @staticmethod
    def _lit_of(e):
        if not isinstance(e, ast.Lit):
            raise SQLError("tuple literals must contain only literals")
        return e.value

    def func_call(self, name: str):
        """Scalar function call NAME(arg, ...) — names stay usable as
        plain identifiers elsewhere (contextual, like sql3's Call)."""
        self.expect("op", "(")
        if name.upper() == "CAST":
            # CAST(expr AS type[(scale)]) — sql3/parser castExpr
            e = self.expr()
            self.expect_kw("as")
            t = self.next().value.lower()
            if t not in _TYPES:
                raise SQLError(f"unknown cast type {t!r}")
            scale = 0
            if t == "decimal" and self.accept("op", "("):
                scale = int(self.expect("number").value)
                self.expect("op", ")")
            self.expect("op", ")")
            return ast.Func("CAST", [e, ast.Lit(t), ast.Lit(scale)])
        args = []
        if not self.accept("op", ")"):
            while True:
                args.append(self.expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return ast.Func(name.upper(), args)

    def aggregate(self):
        func = self.next().value
        self.expect("op", "(")
        distinct = bool(self.kw("distinct"))
        if self.accept("op", "*"):
            # only COUNT takes '*' (defs_aggregate: sum(*)/avg(*)/
            # min(*) are analysis errors)
            if func != "count":
                raise SQLError(
                    f"{func}: column reference expected, got '*'")
            arg = None
        else:
            # aggregates accept arbitrary scalar expressions
            # (defs_aggregate: sum(d1 + 5), avg(len(s1)), sum(1))
            arg = self.expr()
        extra = None
        if func == "percentile":
            self.expect("op", ",")
            extra = self.literal_value()
        elif func == "corr":
            # CORR(x, y) — two column args (expressionagg.go:949)
            self.expect("op", ",")
            extra = ast.Col(self.expect("ident").value)
        self.expect("op", ")")
        return ast.Agg(func, arg, distinct=distinct, extra=extra)

    def literal_value(self):
        t = self.next()
        if t.kind == "number":
            return Decimal(t.value) if "." in t.value else int(t.value)
        if t.kind == "op" and t.value == "-":
            v = self.literal_value()
            return -v
        if t.kind == "string":
            return t.value
        if t.kind == "keyword" and t.value in ("true", "false", "null"):
            return {"true": True, "false": False, "null": None}[t.value]
        if t.kind == "op" and t.value == "(":
            # tuple literal for set columns: (1, 2, 3) or ('a','b')
            items = []
            while True:
                items.append(self.literal_value())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            return items
        if t.kind == "op" and t.value == "[":
            # bracket set literal [1, 2] / ['a', 'b'] (sql3/parser
            # exprList square-bracket form; [] is the empty set)
            items = []
            if not self.accept("op", "]"):
                while True:
                    items.append(self.literal_value())
                    if not self.accept("op", ","):
                        break
                self.expect("op", "]")
            return items
        if t.kind == "op" and t.value == "{":
            # time-quantum pair literal {timestamp, [members]}
            # (sql3/parser tupleExpr; defs_timequantum)
            ts = self.literal_value()
            self.expect("op", ",")
            vals = self.literal_value()
            self.expect("op", "}")
            if not isinstance(vals, list):
                raise SQLError(
                    "time-quantum literal takes {timestamp, [set]}")
            return [ts, vals]
        if t.kind == "ident" and t.value.lower() in (
                "current_timestamp", "current_date"):
            import datetime as dt
            now = dt.datetime.utcnow().replace(microsecond=0)
            if t.value.lower() == "current_date":
                now = now.replace(hour=0, minute=0, second=0)
            return now
        raise SQLError(f"expected literal at {t.pos}, got {t.value!r}")


def parse_sql(text: str):
    return Parser(text).parse()
