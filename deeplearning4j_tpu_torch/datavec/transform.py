"""Schema + TransformProcess — org/datavec/api/transform/** parity (the
port's copy of deeplearning4j_tpu/datavec/transform.py).

Reference (path-cite, mount empty this round):
- ``schema/Schema.java`` — ordered, typed column metadata with a builder
  (addColumnString/Integer/Double/Categorical/Time...).
- ``TransformProcess.java`` — an immutable pipeline of column transforms built
  fluently (removeColumns, filter, categoricalToInteger, categoricalToOneHot,
  integerMathOp, doubleMathOp, renameColumn, reorderColumns, stringToTimeTransform,
  conditionalReplaceValueTransform...), executed locally or on Spark
  (LocalTransformExecutor / SparkTransformExecutor).

TPU-native stance: transforms are pure host-side functions record→record; the
"executor" is a list comprehension (local) — Spark-scale execution maps to the
distributed input pipeline instead, not re-implemented here. Each step also
transforms the schema, so final_schema() gives the post-pipeline column map —
the invariant the reference tests (TransformProcessTest) assert.
"""

from __future__ import annotations

import math
import time as _time
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence


class ColumnType(Enum):
    String = "String"
    Integer = "Integer"
    Long = "Long"
    Double = "Double"
    Float = "Float"
    Categorical = "Categorical"
    Time = "Time"
    Bytes = "Bytes"
    NDArray = "NDArray"


class Schema:
    """Ordered typed columns (Schema.java parity)."""

    def __init__(self, columns: Optional[List[tuple]] = None):
        # columns: list of (name, ColumnType, meta) — meta holds categorical
        # state lists etc.
        self.columns: List[tuple] = list(columns or [])

    # -- builder ------------------------------------------------------------
    class Builder:
        def __init__(self):
            self._cols: List[tuple] = []

        def add_column_string(self, *names):
            for n in names:
                self._cols.append((n, ColumnType.String, None))
            return self

        def add_column_integer(self, *names):
            for n in names:
                self._cols.append((n, ColumnType.Integer, None))
            return self

        def add_column_long(self, *names):
            for n in names:
                self._cols.append((n, ColumnType.Long, None))
            return self

        def add_column_double(self, *names):
            for n in names:
                self._cols.append((n, ColumnType.Double, None))
            return self

        def add_column_float(self, *names):
            for n in names:
                self._cols.append((n, ColumnType.Float, None))
            return self

        def add_column_categorical(self, name, *states):
            self._cols.append((name, ColumnType.Categorical, list(states)))
            return self

        def add_column_time(self, name, timezone="UTC"):
            self._cols.append((name, ColumnType.Time, timezone))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()

    # -- accessors ----------------------------------------------------------
    def column_names(self) -> List[str]:
        return [c[0] for c in self.columns]

    def column_index(self, name: str) -> int:
        return self.column_names().index(name)

    def column_type(self, name: str) -> ColumnType:
        return self.columns[self.column_index(name)][1]

    def meta(self, name: str):
        return self.columns[self.column_index(name)][2]

    def num_columns(self) -> int:
        return len(self.columns)

    def __repr__(self):
        cols = ", ".join(f"{n}:{t.value}" for n, t, _ in self.columns)
        return f"Schema[{cols}]"


class _Step:
    """One transform: fn(record, schema) -> record|None, plus schema_fn."""

    def __init__(self, name, record_fn, schema_fn):
        self.name = name
        self.record_fn = record_fn
        self.schema_fn = schema_fn


class TransformProcess:
    """Immutable transform pipeline (TransformProcess.java parity)."""

    def __init__(self, initial_schema: Schema, steps: List[_Step]):
        self.initial_schema = initial_schema
        self.steps = steps
        self._schemas = [initial_schema]
        for s in steps:
            self._schemas.append(s.schema_fn(self._schemas[-1]))

    def final_schema(self) -> Schema:
        return self._schemas[-1]

    # -- execution ----------------------------------------------------------
    def execute_record(self, record: Sequence[Any]):
        rec = list(record)
        for s, schema in zip(self.steps, self._schemas):
            rec = s.record_fn(rec, schema)
            if rec is None:
                return None
        return rec

    def execute(self, records: Sequence[Sequence[Any]]) -> List[List[Any]]:
        """LocalTransformExecutor.execute parity."""
        out = []
        for r in records:
            t = self.execute_record(r)
            if t is not None:
                out.append(t)
        return out

    # -- builder ------------------------------------------------------------
    class Builder:
        def __init__(self, initial_schema: Schema):
            self.schema = initial_schema
            self.steps: List[_Step] = []

        def _add(self, name, record_fn, schema_fn):
            self.steps.append(_Step(name, record_fn, schema_fn))
            return self

        def remove_columns(self, *names):
            def rec(r, schema):
                keep = [i for i, n in enumerate(schema.column_names()) if n not in names]
                return [r[i] for i in keep]

            def sch(schema):
                return Schema([c for c in schema.columns if c[0] not in names])

            return self._add(f"remove{names}", rec, sch)

        def remove_all_columns_except_for(self, *names):
            def rec(r, schema):
                return [r[i] for i, n in enumerate(schema.column_names()) if n in names]

            def sch(schema):
                return Schema([c for c in schema.columns if c[0] in names])

            return self._add(f"keep{names}", rec, sch)

        def rename_column(self, old, new):
            def sch(schema):
                return Schema([
                    (new if n == old else n, t, m) for n, t, m in schema.columns
                ])

            return self._add(f"rename {old}->{new}", lambda r, s: r, sch)

        def reorder_columns(self, *names):
            def rec(r, schema):
                idx = [schema.column_index(n) for n in names]
                rest = [i for i in range(len(r)) if i not in idx]
                return [r[i] for i in idx + rest]

            def sch(schema):
                named = [schema.columns[schema.column_index(n)] for n in names]
                rest = [c for c in schema.columns if c[0] not in names]
                return Schema(named + rest)

            return self._add("reorder", rec, sch)

        def filter(self, predicate: Callable[[list, Schema], bool]):
            """Drop records where predicate is True (FilterOp parity)."""

            def rec(r, schema):
                return None if predicate(r, schema) else r

            return self._add("filter", rec, lambda s: s)

        def categorical_to_integer(self, *names):
            def rec(r, schema):
                r = list(r)
                for n in names:
                    i = schema.column_index(n)
                    states = schema.meta(n)
                    r[i] = states.index(r[i])
                return r

            def sch(schema):
                return Schema([
                    (n, ColumnType.Integer if n in names else t,
                     None if n in names else m)
                    for n, t, m in schema.columns
                ])

            return self._add("cat2int", rec, sch)

        def categorical_to_one_hot(self, *names):
            def rec(r, schema):
                out = []
                for i, (n, t, m) in enumerate(schema.columns):
                    if n in names:
                        states = m
                        onehot = [0] * len(states)
                        onehot[states.index(r[i])] = 1
                        out.extend(onehot)
                    else:
                        out.append(r[i])
                return out

            def sch(schema):
                cols = []
                for n, t, m in schema.columns:
                    if n in names:
                        cols.extend(
                            (f"{n}[{s}]", ColumnType.Integer, None) for s in m
                        )
                    else:
                        cols.append((n, t, m))
                return Schema(cols)

            return self._add("cat2onehot", rec, sch)

        def string_to_categorical(self, name, states):
            def sch(schema):
                return Schema([
                    (n, ColumnType.Categorical if n == name else t,
                     list(states) if n == name else m)
                    for n, t, m in schema.columns
                ])

            return self._add("str2cat", lambda r, s: r, sch)

        def convert_to_double(self, *names):
            def rec(r, schema):
                r = list(r)
                for n in names:
                    i = schema.column_index(n)
                    r[i] = float(r[i])
                return r

            def sch(schema):
                return Schema([
                    (n, ColumnType.Double if n in names else t, m)
                    for n, t, m in schema.columns
                ])

            return self._add("toDouble", rec, sch)

        def convert_to_integer(self, *names):
            def rec(r, schema):
                r = list(r)
                for n in names:
                    i = schema.column_index(n)
                    r[i] = int(float(r[i]))
                return r

            def sch(schema):
                return Schema([
                    (n, ColumnType.Integer if n in names else t, m)
                    for n, t, m in schema.columns
                ])

            return self._add("toInt", rec, sch)

        def double_math_op(self, name, op: str, value: float):
            """op ∈ add/subtract/multiply/divide/modulus/power (MathOp parity)."""
            fns = {
                "add": lambda v: v + value,
                "subtract": lambda v: v - value,
                "multiply": lambda v: v * value,
                "divide": lambda v: v / value,
                "modulus": lambda v: math.fmod(v, value),
                "power": lambda v: v ** value,
            }

            def rec(r, schema):
                r = list(r)
                i = schema.column_index(name)
                r[i] = fns[op](float(r[i]))
                return r

            return self._add(f"math {op}", rec, lambda s: s)

        def double_column_transform(self, name, fn: Callable[[float], float]):
            def rec(r, schema):
                r = list(r)
                i = schema.column_index(name)
                r[i] = fn(float(r[i]))
                return r

            return self._add("doubleTransform", rec, lambda s: s)

        def conditional_replace_value_transform(self, name, new_value,
                                                condition: Callable[[Any], bool]):
            def rec(r, schema):
                r = list(r)
                i = schema.column_index(name)
                if condition(r[i]):
                    r[i] = new_value
                return r

            return self._add("condReplace", rec, lambda s: s)

        def string_to_time(self, name, fmt: str = "%Y-%m-%d %H:%M:%S"):
            """Parse to UTC epoch millis (StringToTimeTransform parity —
            timegm, not mktime: results must not depend on host timezone)."""
            import calendar

            def rec(r, schema):
                r = list(r)
                i = schema.column_index(name)
                t = _time.strptime(r[i], fmt)
                r[i] = int(calendar.timegm(t) * 1000)
                return r

            def sch(schema):
                return Schema([
                    (n, ColumnType.Time if n == name else t, m)
                    for n, t, m in schema.columns
                ])

            return self._add("str2time", rec, sch)

        def append_string_column_transform(self, name, to_append: str):
            def rec(r, schema):
                r = list(r)
                i = schema.column_index(name)
                r[i] = str(r[i]) + to_append
                return r

            return self._add("appendStr", rec, lambda s: s)

        def replace_missing_value_with(self, name, value):
            """ReplaceInvalidWithIntegerTransform/fillna parity: None or
            empty-string cells become ``value``."""

            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                v = r[i]
                missing = v is None or v == ""
                if not missing and isinstance(v, float):
                    missing = math.isnan(v)  # same rule filter_invalid uses
                if missing:
                    r[i] = value
                return r

            return self._add(f"fillna {name}", rec, lambda s: s)

        def filter_invalid_values(self, *names):
            """Drop records whose named numeric cells are None/''/NaN
            (FilterInvalidValues parity)."""

            def bad(v):
                if v is None or v == "":
                    return True
                try:
                    return math.isnan(float(v))
                except (TypeError, ValueError):
                    return True

            def rec(r, schema):
                return None if any(
                    bad(r[schema.column_index(n)]) for n in names) else r

            return self._add(f"filter_invalid{names}", rec, lambda s: s)

        def add_constant_column(self, name, col_type: "ColumnType", value):
            def rec(r, schema):
                return list(r) + [value]

            def sch(schema):
                return Schema(schema.columns + [(name, col_type, None)])

            return self._add(f"const {name}", rec, sch)

        def duplicate_column(self, name, new_name):
            def rec(r, schema):
                return list(r) + [r[schema.column_index(name)]]

            def sch(schema):
                n, t, m = schema.columns[schema.column_index(name)]
                return Schema(schema.columns + [(new_name, t, m)])

            return self._add(f"dup {name}", rec, sch)

        def integer_to_categorical(self, name, states):
            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                v = int(r[i])
                if not 0 <= v < len(states):
                    raise ValueError(
                        f"integer_to_categorical: value {v} out of range "
                        f"for {len(states)} states in column {name!r}")
                r[i] = states[v]
                return r

            def sch(schema):
                return Schema([
                    (n, ColumnType.Categorical if n == name else t,
                     list(states) if n == name else m)
                    for n, t, m in schema.columns
                ])

            return self._add(f"int2cat {name}", rec, sch)

        def integer_math_op(self, name, op: str, value: int):
            """IntegerMathOpTransform parity: Add/Subtract/Multiply/Divide/
            Modulus/ScalarMin/ScalarMax. Divide/Modulus follow the
            reference's JAVA semantics — truncation toward zero, remainder
            keeping the dividend's sign — not Python floor division."""
            def trunc_div(v):
                # exact integer truncation toward zero (no float64 detour —
                # Long-range values stay exact)
                q = abs(v) // abs(value)
                return q if (v < 0) == (value < 0) else -q

            fns = {"Add": lambda v: v + value,
                   "Subtract": lambda v: v - value,
                   "Multiply": lambda v: v * value,
                   "Divide": trunc_div,
                   "Modulus": lambda v: v - trunc_div(v) * value,
                   "ScalarMin": lambda v: min(v, value),
                   "ScalarMax": lambda v: max(v, value)}
            fn = fns[op]

            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                r[i] = fn(int(r[i]))
                return r

            return self._add(f"imath {op} {name}", rec, lambda s: s)

        def change_case_string_transform(self, name, upper=False):
            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                r[i] = str(r[i]).upper() if upper else str(r[i]).lower()
                return r

            return self._add(f"case {name}", rec, lambda s: s)

        def replace_string_transform(self, name, pattern, replacement,
                                     regex=False):
            """ReplaceStringTransform / RegexReplace parity."""
            import re as _re

            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                r[i] = (_re.sub(pattern, replacement, str(r[i])) if regex
                        else str(r[i]).replace(pattern, replacement))
                return r

            return self._add(f"replace {name}", rec, lambda s: s)

        def map_string(self, name, fn: Callable[[str], str]):
            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                r[i] = fn(str(r[i]))
                return r

            return self._add(f"map_string {name}", rec, lambda s: s)

        def normalize(self, name, min_value: float, max_value: float):
            """Min-max scale to [0, 1] using the given statistics (DataVec's
            Normalize.MinMax over a DataAnalysis)."""
            span = max(max_value - min_value, 1e-12)

            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                r[i] = (float(r[i]) - min_value) / span
                return r

            return self._add(f"minmax {name}", rec, lambda s: s)

        def standardize(self, name, mean: float, stdev: float):
            """Z-score using given statistics (Normalize.Standardize)."""
            sd = max(stdev, 1e-12)

            def rec(r, schema):
                i = schema.column_index(name)
                r = list(r)
                r[i] = (float(r[i]) - mean) / sd
                return r

            return self._add(f"standardize {name}", rec, lambda s: s)

        def derive_column_from_time(self, name, field: str,
                                    new_name: "Optional[str]" = None):
            """DeriveColumnsFromTimeTransform parity: extract hour_of_day /
            day_of_week / day_of_month / month / year from a Time column
            (epoch milliseconds, UTC)."""
            import datetime as _dt

            getters = {
                "hour_of_day": lambda d: d.hour,
                # isoweekday: Monday=1..Sunday=7 (Joda/DataVec convention)
                "day_of_week": lambda d: d.isoweekday(),
                "day_of_month": lambda d: d.day,
                "month": lambda d: d.month,
                "year": lambda d: d.year,
            }
            get = getters[field]
            out = new_name or f"{name}_{field}"

            def rec(r, schema):
                i = schema.column_index(name)
                d = _dt.datetime.fromtimestamp(int(r[i]) / 1000.0,
                                               _dt.timezone.utc)
                return list(r) + [get(d)]

            def sch(schema):
                return Schema(schema.columns + [(out, ColumnType.Integer,
                                                 None)])

            return self._add(f"time {field} {name}", rec, sch)

        def build(self) -> "TransformProcess":
            return TransformProcess(self.schema, self.steps)

    @staticmethod
    def builder(schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(schema)


class Join:
    """Record-collection join (org/datavec/api/transform/join/Join.java
    parity: Inner / LeftOuter / RightOuter / FullOuter on key columns; the
    reference executes these on Spark — here locally over record lists).

        join = (Join.Builder("inner")
                .set_join_columns("id")
                .set_schemas(left_schema, right_schema).build())
        rows = join.execute(left_records, right_records)
    """

    TYPES = ("inner", "leftouter", "rightouter", "fullouter")

    def __init__(self, join_type: str, keys: List[str],
                 left_schema: Schema, right_schema: Schema):
        jt = join_type.lower().replace("_", "")
        if jt not in self.TYPES:
            raise ValueError(f"join_type must be one of {self.TYPES}")
        self.join_type = jt
        self.keys = list(keys)
        self.left_schema = left_schema
        self.right_schema = right_schema
        self._l_idx = [left_schema.column_names().index(k) for k in self.keys]
        self._r_idx = [right_schema.column_names().index(k) for k in self.keys]
        # output: all left columns + right columns minus the keys
        self._r_keep = [i for i, n in enumerate(right_schema.column_names())
                        if n not in self.keys]

    class Builder:
        def __init__(self, join_type: str = "inner"):
            self._type = join_type
            self._keys: List[str] = []
            self._left = self._right = None

        def set_join_columns(self, *names: str):
            self._keys = list(names)
            return self

        def set_schemas(self, left: Schema, right: Schema):
            self._left, self._right = left, right
            return self

        def build(self) -> "Join":
            return Join(self._type, self._keys, self._left, self._right)

    def output_schema(self) -> Schema:
        cols = list(self.left_schema.columns)
        cols += [self.right_schema.columns[i] for i in self._r_keep]
        return Schema(cols)

    def _null_row(self, schema, keep=None):
        n = len(schema.columns) if keep is None else len(keep)
        return [None] * n

    def execute(self, left_records, right_records) -> List[list]:
        right_by_key: dict = {}
        for r in right_records:
            right_by_key.setdefault(
                tuple(r[i] for i in self._r_idx), []).append(r)
        out = []
        matched_right = set()
        for l in left_records:
            k = tuple(l[i] for i in self._l_idx)
            matches = right_by_key.get(k, [])
            if matches:
                matched_right.add(k)
                for r in matches:
                    out.append(list(l) + [r[i] for i in self._r_keep])
            elif self.join_type in ("leftouter", "fullouter"):
                out.append(list(l) + self._null_row(self.right_schema,
                                                    self._r_keep))
        if self.join_type in ("rightouter", "fullouter"):
            ln = len(self.left_schema.columns)
            for k, rs in right_by_key.items():
                if k in matched_right:
                    continue
                for r in rs:
                    row = [None] * ln
                    for ki, li in zip(k, self._l_idx):
                        row[li] = ki  # key values survive on the left side
                    out.append(row + [r[i] for i in self._r_keep])
        return out


class Reducer:
    """Group-by aggregation (org/datavec/api/transform/reduce/Reducer.java,
    path-cite): records sharing the key column values collapse to one row
    per group, non-key columns reduced by the configured op.

    Ops: sum, mean, min, max, count, stdev, first, last, takefirst (alias
    of first, as upstream).
    """

    _OPS = {
        "sum": lambda vs: sum(float(v) for v in vs),
        "mean": lambda vs: sum(float(v) for v in vs) / len(vs),
        "min": lambda vs: min(float(v) for v in vs),
        "max": lambda vs: max(float(v) for v in vs),
        "count": lambda vs: len(vs),
        "stdev": lambda vs: _stdev([float(v) for v in vs]),
        "first": lambda vs: vs[0],
        "takefirst": lambda vs: vs[0],
        "last": lambda vs: vs[-1],
    }
    _NUMERIC = {"sum", "mean", "min", "max", "stdev"}

    def __init__(self, schema: Schema, keys: List[str],
                 default_op: str = "takefirst",
                 column_ops: "Optional[dict]" = None):
        self.schema = schema
        self.keys = list(keys)
        self.default_op = default_op.lower()
        self.column_ops = {k: v.lower() for k, v in (column_ops or {}).items()}
        for o in [self.default_op, *self.column_ops.values()]:
            if o not in self._OPS:
                raise ValueError(f"unknown reduce op {o!r}")

    class Builder:
        def __init__(self, schema: Schema, *keys: str):
            self._schema = schema
            self._keys = list(keys)
            self._default = "takefirst"
            self._ops: dict = {}

        def default_op(self, op: str):
            self._default = op
            return self

        def op(self, op: str, *names: str):
            for n in names:
                self._ops[n] = op
            return self

        # upstream spelling helpers
        def sum_columns(self, *names):
            return self.op("sum", *names)

        def mean_columns(self, *names):
            return self.op("mean", *names)

        def min_columns(self, *names):
            return self.op("min", *names)

        def max_columns(self, *names):
            return self.op("max", *names)

        def count_columns(self, *names):
            return self.op("count", *names)

        def stdev_columns(self, *names):
            return self.op("stdev", *names)

        def build(self) -> "Reducer":
            return Reducer(self._schema, self._keys, self._default,
                           self._ops)

    def output_schema(self) -> Schema:
        cols = []
        for n, t, m in self.schema.columns:
            if n in self.keys:
                cols.append((n, t, m))
                continue
            o = self.column_ops.get(n, self.default_op)
            if o == "count":
                cols.append((f"count({n})", ColumnType.Long, None))
            elif o in self._NUMERIC:
                cols.append((f"{o}({n})", ColumnType.Double, None))
            else:
                cols.append((n, t, m))
        return Schema(cols)

    def execute(self, records: Sequence[Sequence[Any]]) -> List[list]:
        names = self.schema.column_names()
        kidx = [self.schema.column_index(k) for k in self.keys]
        groups: dict = {}
        order = []
        for r in records:
            key = tuple(r[i] for i in kidx)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        out = []
        for key in order:
            rows = groups[key]
            row = []
            for i, n in enumerate(names):
                if n in self.keys:
                    row.append(rows[0][i])
                    continue
                o = self.column_ops.get(n, self.default_op)
                row.append(self._OPS[o]([r[i] for r in rows]))
            out.append(row)
        return out


def _stdev(vals):
    if len(vals) < 2:
        return 0.0
    m = sum(vals) / len(vals)
    return (sum((v - m) ** 2 for v in vals) / (len(vals) - 1)) ** 0.5
