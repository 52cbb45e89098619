"""Per-index dataframe: the wide-column companion store.

The reference's experimental dataframe beside the bitmaps (apply.go:1-25
``Apply`` over columns, arrow.go Arrow import and export, the
``/index/{i}/dataframe`` route, http_handler.go:506), persisted as
Parquet in ``<index path>/dataframe.parquet``; ``pyarrow`` is imported
only when a dataframe is saved, loaded or exported.

Columns are held on the host as Python lists keyed by the record id
``_id``.  ``apply`` evaluates an expression over the columns on the
host, through a sealed AST whitelist.  ``aggregate`` reduces a numeric
column as a torch tensor on the dataframe's device: the CUDA card
unless the caller passes ``device="cpu"``; there is no host path on the
card.  It returns what the JAX package's ``aggregate`` returns with
JAX's 64-bit mode off, where the column enters the device as 32-bit
values: an integer column wraps to int32 (as numpy's ``astype`` wraps)
and its sum wraps modulo 2^32, a float column rounds to float32 and
its count comes back as a float, and a mean is a float32 value.  Float
sums and means may differ from JAX's in the last bits, since the card
adds in another order.
"""

from __future__ import annotations

import ast
import os
import threading

import numpy as np
import torch


class DataframeError(Exception):
    pass


# the Apply expression language: arithmetic/comparison/boolean ops over
# column names plus these functions — NO attribute access, NO arbitrary
# names, so there is no path to modules, dunders, or ctypes
_FUNCS = {"abs": np.abs, "where": np.where, "log": np.log,
          "exp": np.exp, "sqrt": np.sqrt, "sum": np.sum,
          "mean": np.mean, "min": np.min, "max": np.max,
          "minimum": np.minimum, "maximum": np.maximum}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.Call, ast.Name, ast.Constant, ast.IfExp, ast.Load,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
    ast.Pow, ast.USub, ast.UAdd, ast.Not, ast.Invert,
    ast.And, ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt,
    ast.GtE, ast.BitAnd, ast.BitOr, ast.BitXor,
)


def _safe_eval(expr: str, names: dict):
    """Evaluate a column expression over a sealed AST whitelist.

    Blacklists don't survive adversaries (numpy alone reexports
    ctypes); instead only the node types above are compiled, calls
    may target only _FUNCS, and names resolve only to columns or
    _FUNCS entries.
    """
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise DataframeError(f"bad expression: {e}")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise DataframeError(
                f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name)
                    and node.func.id in _FUNCS) or node.keywords:
                raise DataframeError("only the built-in functions "
                                     f"{sorted(_FUNCS)} may be called")
        if isinstance(node, ast.Name) and \
                node.id not in names and node.id not in _FUNCS:
            raise DataframeError(f"unknown name: {node.id}")
    ns = {**_FUNCS, **names, "__builtins__": {}}
    return eval(compile(tree, "<apply>", "eval"), ns)  # noqa: S307


class IndexDataframe:
    """Columnar rows keyed by the index's record id (_id)."""

    #: appended rows buffered before an automatic Parquet rewrite —
    #: saving per request would re-serialize the whole table each time
    SAVE_EVERY = 4096

    def __init__(self, path: str | None = None):
        self.path = path
        self._cols: dict[str, list] = {"_id": []}
        self._lock = threading.RLock()
        self._unsaved = 0
        if path and os.path.exists(self._file):
            self._load()

    @property
    def _file(self) -> str:
        return os.path.join(self.path, "dataframe.parquet")

    # -- ingest --------------------------------------------------------

    def add_rows(self, rows: list[dict]):
        """Append records ({"_id": ..., col: value, ...}); ragged
        columns null-fill (arrow.go ingest semantics).  Validates the
        whole batch first — a rejected batch appends NOTHING, so a
        client retry after a 400 can't duplicate rows."""
        for i, r in enumerate(rows):
            if "_id" not in r:
                raise DataframeError(f"row {i} missing _id")
        with self._lock:
            n = len(self._cols["_id"])
            for r in rows:
                for k in r:
                    if k not in self._cols:
                        self._cols[k] = [None] * n
                for k in self._cols:
                    self._cols[k].append(r.get(k))
                n += 1
            self._unsaved += len(rows)

    # -- persistence (Parquet like the reference) ----------------------

    def save(self):
        if not self.path:
            return
        import pyarrow as pa
        import pyarrow.parquet as pq
        os.makedirs(self.path, exist_ok=True)
        with self._lock:
            table = pa.table({k: pa.array(v)
                              for k, v in self._cols.items()})
            pq.write_table(table, self._file)
            self._unsaved = 0

    def maybe_save(self):
        """Save when enough appends accumulated (the ingest path's
        amortized persistence; sync() forces the tail out)."""
        with self._lock:
            due = self._unsaved >= self.SAVE_EVERY
        if due:
            self.save()

    def sync(self):
        with self._lock:
            dirty = self._unsaved > 0
        if dirty:
            self.save()

    def _load(self):
        import pyarrow.parquet as pq
        table = pq.read_table(self._file)
        self._cols = {name: table.column(name).to_pylist()
                      for name in table.column_names}
        self._cols.setdefault("_id", [])

    # -- reads ---------------------------------------------------------

    @property
    def n_rows(self) -> int:
        with self._lock:
            return len(self._cols["_id"])

    def schema(self) -> list[dict]:
        out = []
        with self._lock:  # add_rows may be inserting new columns
            items = [(n, list(v)) for n, v in self._cols.items()]
        for name, vals in items:
            sample = next((v for v in vals if v is not None), None)
            t = ("int" if isinstance(sample, (int, np.integer))
                 and not isinstance(sample, bool) else
                 "bool" if isinstance(sample, bool) else
                 "float" if isinstance(sample, (float, np.floating)) else
                 "string")
            out.append({"name": name, "type": t})
        return out

    def to_arrow(self):
        import pyarrow as pa
        with self._lock:
            return pa.table({k: pa.array(v)
                             for k, v in self._cols.items()})

    def column(self, name: str) -> np.ndarray:
        with self._lock:
            if name not in self._cols:
                raise DataframeError(f"no such column: {name}")
            return np.asarray(self._cols[name])

    # -- compute (apply.go Apply; device-side aggregation) -------------

    def apply(self, expr: str, columns: list[str] | None = None):
        """Evaluate a numpy expression over columns; names bind to the
        column arrays.  Returns the result column as a row-aligned
        list (or a scalar for reducing expressions)."""
        with self._lock:
            names = {}
            for name, vals in self._cols.items():
                if columns is not None and name not in columns \
                        and name != "_id":
                    continue
                try:
                    names[name] = np.asarray(
                        [0 if v is None else v for v in vals])
                except Exception:
                    names[name] = np.asarray(vals, dtype=object)
        try:
            out = _safe_eval(expr, names)
        except DataframeError:
            raise
        except Exception as e:
            raise DataframeError(f"apply failed: {e}")
        if np.isscalar(out):
            return out
        return np.asarray(out).tolist()

    def aggregate(self, op: str, column: str, device=None):
        """Reduce a numeric column on the device (the card unless
        ``device`` says otherwise): "sum", "min", "max", "mean" or
        "count", under the JAX package's 32-bit rule (module
        docstring).  A null counts as 0, and toward count."""
        vals = self.column(column)
        if vals.dtype == object:
            try:
                vals = np.array([0 if v is None else v for v in vals],
                                dtype=np.float64)
            except (TypeError, ValueError):
                raise DataframeError(f"column {column} is not numeric")
        if op not in _AGG_OPS:
            raise DataframeError(f"unknown aggregate {op!r}")
        if vals.dtype.kind == "f":
            vals = vals.astype(np.float32)
        elif vals.dtype.kind in "iu":
            vals = vals.astype(np.int64).astype(np.int32)
        elif vals.dtype.kind != "b":
            raise DataframeError(f"column {column} is not numeric")
        is_float = vals.dtype.kind == "f"
        if op == "count":
            n = vals.shape[0]
            return float(n) if is_float else n
        t = torch.from_numpy(vals).to(_device(device))
        if op == "mean":
            return float(t.to(torch.float32).mean())
        if op == "sum":
            out = t.sum() if is_float else t.sum(dtype=torch.int64)
        else:
            out = t.min() if op == "min" else t.max()
        out = out.item()
        if is_float:
            return float(out)
        # 32-bit accumulation wraps modulo 2^32
        return (int(out) + (1 << 31)) % (1 << 32) - (1 << 31)


_AGG_OPS = ("sum", "min", "max", "mean", "count")


def _device(device) -> torch.device:
    """``None`` means the CUDA card, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: aggregate runs on the card; pass "
                "device='cpu' to reduce on the CPU instead")
        return torch.device("cuda")
    return torch.device(device)
