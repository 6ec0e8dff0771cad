"""DataVec-style transform pipeline: Schema + TransformProcess (PyTorch port
of ``deeplearning4j_tpu/datasets/transform.py``; host numpy, a copy whose
JSON reads in both packages).

Capability parity with the DataVec ETL layer the reference consumes
(deeplearning4j-core/src/main/java/org/deeplearning4j/datasets/datavec/
RecordReaderDataSetIterator.java pulls records through DataVec's
Schema/TransformProcess; DataVec itself lives in its own repo). The surface
mirrors DataVec's: a Schema describes typed columns, a TransformProcess is
an ordered list of serializable column operations whose output schema is
derivable WITHOUT data, and an executor applies them to records.

Operations are COLUMNAR numpy transforms (vectorized over the whole record
batch), not per-record Writable visitors; the pipeline's output is a numpy
matrix that ``fit`` takes as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

COLUMN_TYPES = ("double", "integer", "categorical", "string", "time")


@dataclass(frozen=True)
class ColumnMeta:
    name: str
    kind: str
    categories: Tuple[str, ...] = ()   # categorical only

    def __post_init__(self):
        if self.kind not in COLUMN_TYPES:
            raise ValueError(f"unknown column type {self.kind!r}")


class Schema:
    """Typed column layout (datavec Schema). Build via the fluent builder::

        schema = (Schema.builder()
                  .add_double("sepal_len")
                  .add_categorical("species", ["a", "b", "c"])
                  .build())
    """

    def __init__(self, columns: Sequence[ColumnMeta]):
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        self.columns: Tuple[ColumnMeta, ...] = tuple(columns)

    # -- builder -----------------------------------------------------------
    class Builder:
        def __init__(self):
            self._cols: List[ColumnMeta] = []

        def add_double(self, *names: str) -> "Schema.Builder":
            self._cols += [ColumnMeta(n, "double") for n in names]
            return self

        def add_integer(self, *names: str) -> "Schema.Builder":
            self._cols += [ColumnMeta(n, "integer") for n in names]
            return self

        def add_string(self, *names: str) -> "Schema.Builder":
            self._cols += [ColumnMeta(n, "string") for n in names]
            return self

        def add_time(self, *names: str) -> "Schema.Builder":
            self._cols += [ColumnMeta(n, "time") for n in names]
            return self

        def add_categorical(self, name: str, categories: Sequence[str]) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, "categorical", tuple(categories)))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()

    # -- queries -----------------------------------------------------------
    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"no column {name!r}; have {self.names()}")

    def column(self, name: str) -> ColumnMeta:
        return self.columns[self.index_of(name)]

    def __len__(self):
        return len(self.columns)

    def __eq__(self, other):
        return isinstance(other, Schema) and self.columns == other.columns

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"columns": [
            {"name": c.name, "kind": c.kind,
             **({"categories": list(c.categories)} if c.categories else {})}
            for c in self.columns]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema([ColumnMeta(c["name"], c["kind"],
                                  tuple(c.get("categories", ())))
                       for c in d["columns"]])


# ---------------------------------------------------------------------------
# Operations: schema_out(schema) derives the output schema WITHOUT data;
# apply(columns, schema) transforms the columnar dict
# ---------------------------------------------------------------------------

_OPS: Dict[str, type] = {}


def _register_op(name):
    def deco(cls):
        cls.OP = name
        _OPS[name] = cls
        return cls
    return deco


@dataclass
class _Op:
    def schema_out(self, schema: Schema) -> Schema:
        return schema

    def apply(self, cols: Dict[str, np.ndarray], schema: Schema) -> Dict[str, np.ndarray]:
        return cols

    def to_dict(self) -> dict:
        # the type tag lives under "transform", NOT "op" — DoubleMathOp has
        # an instance field named "op" that must round-trip untouched
        d = {"transform": type(self).OP}
        d.update({k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in self.__dict__.items()})
        return d


@_register_op("remove_columns")
@dataclass
class RemoveColumns(_Op):
    names: Tuple[str, ...] = ()

    def schema_out(self, schema):
        for n in self.names:
            schema.index_of(n)  # validate
        return Schema([c for c in schema.columns if c.name not in self.names])

    def apply(self, cols, schema):
        return {k: v for k, v in cols.items() if k not in self.names}


@_register_op("keep_columns")
@dataclass
class KeepColumns(_Op):
    names: Tuple[str, ...] = ()

    def schema_out(self, schema):
        return Schema([schema.column(n) for n in self.names])

    def apply(self, cols, schema):
        return {n: cols[n] for n in self.names}


@_register_op("rename_column")
@dataclass
class RenameColumn(_Op):
    old: str = ""
    new: str = ""

    def schema_out(self, schema):
        schema.index_of(self.old)  # validate: a typo'd rename must not no-op
        return Schema([
            ColumnMeta(self.new, c.kind, c.categories) if c.name == self.old else c
            for c in schema.columns])

    def apply(self, cols, schema):
        return {self.new if k == self.old else k: v for k, v in cols.items()}


@_register_op("categorical_to_integer")
@dataclass
class CategoricalToInteger(_Op):
    name: str = ""

    def schema_out(self, schema):
        c = schema.column(self.name)
        if c.kind != "categorical":
            raise ValueError(f"{self.name} is {c.kind}, not categorical")
        return Schema([ColumnMeta(x.name, "integer") if x.name == self.name else x
                       for x in schema.columns])

    def apply(self, cols, schema):
        cats = list(schema.column(self.name).categories)
        lut = {c: i for i, c in enumerate(cats)}
        vals = cols[self.name]
        try:
            out = np.asarray([lut[str(v)] for v in vals], np.int64)
        except KeyError as e:
            raise ValueError(f"value {e} not in categories {cats}") from None
        new = dict(cols)
        new[self.name] = out
        return new


@_register_op("categorical_to_one_hot")
@dataclass
class CategoricalToOneHot(_Op):
    name: str = ""

    def schema_out(self, schema):
        c = schema.column(self.name)
        if c.kind != "categorical":
            raise ValueError(f"{self.name} is {c.kind}, not categorical")
        out = []
        for x in schema.columns:
            if x.name == self.name:
                out += [ColumnMeta(f"{self.name}[{cat}]", "double")
                        for cat in c.categories]
            else:
                out.append(x)
        return Schema(out)

    def apply(self, cols, schema):
        cats = list(schema.column(self.name).categories)
        lut = {c: i for i, c in enumerate(cats)}
        try:
            idx = np.asarray([lut[str(v)] for v in cols[self.name]], np.int64)
        except KeyError as e:
            raise ValueError(
                f"column {self.name!r}: value {e} not in categories {cats}"
            ) from None
        eye = np.eye(len(cats), dtype=np.float64)[idx]
        out = {}
        for k, v in cols.items():
            if k == self.name:
                for j, cat in enumerate(cats):
                    out[f"{self.name}[{cat}]"] = eye[:, j]
            else:
                out[k] = v
        return out


@_register_op("string_to_categorical")
@dataclass
class StringToCategorical(_Op):
    name: str = ""
    categories: Tuple[str, ...] = ()

    def schema_out(self, schema):
        c = schema.column(self.name)
        if c.kind != "string":
            raise ValueError(f"{self.name} is {c.kind}, not string")
        return Schema([ColumnMeta(x.name, "categorical", tuple(self.categories))
                       if x.name == self.name else x for x in schema.columns])


_MATH = {
    "add": np.add, "subtract": np.subtract, "multiply": np.multiply,
    "divide": np.divide, "power": np.power, "modulus": np.mod,
}


@_register_op("double_math")
@dataclass
class DoubleMathOp(_Op):
    name: str = ""
    op: str = "add"
    scalar: float = 0.0

    def schema_out(self, schema):
        c = schema.column(self.name)
        if c.kind not in ("double", "integer"):
            raise ValueError(f"{self.name} is {c.kind}, not numeric")
        if self.op not in _MATH:
            raise ValueError(f"unknown math op {self.op!r}; have {sorted(_MATH)}")
        return schema

    def apply(self, cols, schema):
        new = dict(cols)
        new[self.name] = _MATH[self.op](
            np.asarray(cols[self.name], np.float64), self.scalar)
        return new


@_register_op("normalize_min_max")
@dataclass
class NormalizeMinMax(_Op):
    """(x - min) / (max - min) with STATED stats (DataVec derives them from
    an analysis pass; pass them explicitly here — data-free schema
    derivation is preserved)."""

    name: str = ""
    min: float = 0.0
    max: float = 1.0

    def schema_out(self, schema):
        if schema.column(self.name).kind not in ("double", "integer"):
            raise ValueError(f"{self.name} is not numeric")
        if self.max <= self.min:
            raise ValueError("max must exceed min")
        return schema

    def apply(self, cols, schema):
        new = dict(cols)
        x = np.asarray(cols[self.name], np.float64)
        new[self.name] = (x - self.min) / (self.max - self.min)
        return new


@_register_op("filter_numeric")
@dataclass
class FilterNumericCondition(_Op):
    """Drop ROWS where the condition holds (datavec ConditionFilter):
    condition in <, <=, >, >=, ==, != against a scalar."""

    name: str = ""
    condition: str = "<"
    value: float = 0.0

    _CMP = {"<": np.less, "<=": np.less_equal, ">": np.greater,
            ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal}

    def schema_out(self, schema):
        if schema.column(self.name).kind not in ("double", "integer"):
            raise ValueError(f"{self.name} is not numeric")
        if self.condition not in self._CMP:
            raise ValueError(f"unknown condition {self.condition!r}")
        return schema

    def apply(self, cols, schema):
        x = np.asarray(cols[self.name], np.float64)
        drop = self._CMP[self.condition](x, self.value)
        keep = ~drop
        return {k: np.asarray(v)[keep] for k, v in cols.items()}


@_register_op("replace_invalid")
@dataclass
class ReplaceInvalidWithValue(_Op):
    """NaN/inf in a numeric column -> value (ReplaceInvalidWithIntegerTransform
    family)."""

    name: str = ""
    value: float = 0.0

    def schema_out(self, schema):
        if schema.column(self.name).kind not in ("double", "integer"):
            raise ValueError(f"{self.name} is not numeric")
        return schema

    def apply(self, cols, schema):
        new = dict(cols)
        x = np.asarray(cols[self.name], np.float64)
        new[self.name] = np.where(np.isfinite(x), x, self.value)
        return new


# ---------------------------------------------------------------------------
# TransformProcess
# ---------------------------------------------------------------------------


class TransformProcess:
    """Ordered, serializable column transforms (datavec TransformProcess).

    ``final_schema`` is derived without data; ``execute`` runs the columnar
    pipeline over records (list of rows, or a columnar dict)."""

    def __init__(self, initial_schema: Schema, ops: Sequence[_Op]):
        self.initial_schema = initial_schema
        self.ops = list(ops)
        # validate the whole chain up front (schema derivation is data-free)
        s = initial_schema
        self._schemas = [s]
        for op in self.ops:
            s = op.schema_out(s)
            self._schemas.append(s)

    def final_schema(self) -> Schema:
        return self._schemas[-1]

    # -- builder -----------------------------------------------------------
    class Builder:
        def __init__(self, schema: Schema):
            self.schema = schema
            self.ops: List[_Op] = []

        def remove_columns(self, *names):
            self.ops.append(RemoveColumns(tuple(names)))
            return self

        def keep_columns(self, *names):
            self.ops.append(KeepColumns(tuple(names)))
            return self

        def rename_column(self, old, new):
            self.ops.append(RenameColumn(old, new))
            return self

        def categorical_to_integer(self, name):
            self.ops.append(CategoricalToInteger(name))
            return self

        def categorical_to_one_hot(self, name):
            self.ops.append(CategoricalToOneHot(name))
            return self

        def string_to_categorical(self, name, categories):
            self.ops.append(StringToCategorical(name, tuple(categories)))
            return self

        def double_math_op(self, name, op, scalar):
            self.ops.append(DoubleMathOp(name, op, scalar))
            return self

        def normalize_min_max(self, name, lo, hi):
            self.ops.append(NormalizeMinMax(name, lo, hi))
            return self

        def filter_numeric(self, name, condition, value):
            self.ops.append(FilterNumericCondition(name, condition, value))
            return self

        def replace_invalid(self, name, value):
            self.ops.append(ReplaceInvalidWithValue(name, value))
            return self

        def build(self) -> "TransformProcess":
            return TransformProcess(self.schema, self.ops)

    @staticmethod
    def builder(schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(schema)

    # -- execution ---------------------------------------------------------
    def _to_columns(self, records) -> Dict[str, np.ndarray]:
        names = self.initial_schema.names()
        if isinstance(records, dict):
            missing = [n for n in names if n not in records]
            if missing:
                raise ValueError(f"columnar input missing {missing}")
            return {n: np.asarray(records[n]) for n in names}
        rows = list(records)
        for r in rows:
            if len(r) != len(names):
                raise ValueError(
                    f"record width {len(r)} != schema width {len(names)}")
        return {n: np.asarray([r[i] for r in rows])
                for i, n in enumerate(names)}

    def execute(self, records) -> Dict[str, np.ndarray]:
        """Run the pipeline; returns the final columnar dict (insertion
        order = final schema order)."""
        cols = self._to_columns(records)
        for op, schema in zip(self.ops, self._schemas[:-1]):
            cols = op.apply(cols, schema)
        final = self.final_schema().names()
        return {n: cols[n] for n in final}

    def execute_to_matrix(self, records) -> np.ndarray:
        """Final columns stacked as a [rows, cols] float matrix (feeds
        DataSet / fit directly); every final column must be numeric."""
        cols = self.execute(records)
        for name in cols:
            kind = self.final_schema().column(name).kind
            if kind not in ("double", "integer"):
                raise ValueError(
                    f"column {name!r} is {kind}; convert it before "
                    "execute_to_matrix")
        return np.stack([np.asarray(cols[n], np.float64)
                         for n in self.final_schema().names()], axis=1)

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"format": "deeplearning4j_tpu/TransformProcess", "version": 1,
                "schema": self.initial_schema.to_dict(),
                "ops": [op.to_dict() for op in self.ops]}

    @staticmethod
    def from_dict(d: dict) -> "TransformProcess":
        schema = Schema.from_dict(d["schema"])
        ops = []
        for od in d["ops"]:
            od = dict(od)
            cls = _OPS[od.pop("transform")]
            kw = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in od.items()}
            ops.append(cls(**kw))
        return TransformProcess(schema, ops)
