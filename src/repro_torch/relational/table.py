"""Columnar tables backed by torch tensors on one device.

The relational substrate of the Cobra reproduction. Tables are columnar
(dict of 1-D ``torch`` tensors on the table's device — the card in
production); bulk compute (filters, gathers, computed columns,
aggregations) runs through torch on that device. Index machinery that is
inherently dynamic-shape (sort/unique/searchsorted on concrete row counts)
uses numpy on host — this mirrors a database runtime, where the executor is
not a compiled graph. Host reads go through ONE accessor,
:meth:`Table.host`, a numpy mirror cached on the immutable table, so a
CUDA table pays one device-to-host copy per column, never one per element.

Wire sizes are modeled separately from storage dtype: a ``varchar(100)``
column is stored as an int32 surrogate key but declares 100 wire bytes,
so that the simulated network-transfer costs match the paper's TPC-DS
row sizing (Sec. VIII).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Field", "Schema", "Table", "resolve_device", "np_dtype_name",
           "host_to_device"]


def _storage_dtype(dtype: str) -> np.dtype:
    """Storage dtype; 64-bit always narrows to 32-bit (torch has no x64
    switch, and the reference stores 32-bit unless jax_enable_x64 is set).

    Wire sizes (cost model) always honor the declared Field dtype/wire_bytes;
    only in-memory storage narrows.
    """
    dt = np.dtype(dtype)
    if dt.itemsize == 8:
        return np.dtype("int32") if dt.kind in "iu" else np.dtype("float32")
    return dt


_NP_TO_TORCH = {
    np.dtype("bool"): torch.bool, np.dtype("int8"): torch.int8,
    np.dtype("uint8"): torch.uint8, np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32, np.dtype("float16"): torch.float16,
    np.dtype("float32"): torch.float32,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def np_dtype_name(t: torch.Tensor) -> str:
    """The numpy dtype string of a tensor's element type (``"int32"`` …) —
    what the reference reads as ``str(np.asarray(x).dtype)``."""
    if t.dtype == torch.int64:
        return "int64"
    if t.dtype == torch.float64:
        return "float64"
    return str(_TORCH_TO_NP[t.dtype])


def resolve_device(device=None) -> torch.device:
    """The device a table or server lives on. ``None`` means the card
    (``"cuda"``); asking for the card where CUDA is unavailable raises —
    the port never drops to the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU, and CUDA is not available "
            "here; pass device='cpu' explicitly to run on the CPU")
    return dev


def host_to_device(arr, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``. Read-only or strided input is
    copied first (``torch.from_numpy`` takes only writable contiguous
    arrays); on the CPU the tensor may share the array's memory."""
    a = np.asarray(arr, dtype=dtype)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device)


def _frozen(arr: np.ndarray) -> np.ndarray:
    arr.flags.writeable = False
    return arr


@dataclasses.dataclass(frozen=True)
class Field:
    """One column: storage dtype + simulated wire width in bytes."""

    name: str
    dtype: str = "int32"  # numpy dtype string: int32/int64/float32/float64
    wire_bytes: Optional[int] = None  # defaults to dtype itemsize

    @property
    def itemsize(self) -> int:
        return int(np.dtype(self.dtype).itemsize)

    @property
    def bytes_on_wire(self) -> int:
        return self.wire_bytes if self.wire_bytes is not None else self.itemsize


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate column names in schema: {names}")

    @staticmethod
    def of(*fields: Field) -> "Schema":
        return Schema(tuple(fields))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no column {name!r}; have {self.names}")

    def has(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    @property
    def row_bytes(self) -> int:
        """Simulated size of one row on the wire."""
        return sum(f.bytes_on_wire for f in self.fields)

    def subset(self, names: Sequence[str]) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def rename_prefixed(self, prefix: str) -> "Schema":
        return Schema(tuple(dataclasses.replace(f, name=prefix + f.name) for f in self.fields))

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)


class Table:
    """An immutable columnar table. Columns are 1-D torch tensors of equal
    length, all on ``self.device``.

    ``device`` defaults to the device of the tensor columns given; a table
    built only from host data (numpy arrays, lists) with no ``device``
    goes to the default device of :func:`resolve_device`."""

    def __init__(self, name: str, schema: Schema,
                 columns: Mapping[str, object], device=None):
        self.name = name
        self.schema = schema
        if device is None:
            devs = {c.device for c in columns.values()
                    if isinstance(c, torch.Tensor)}
            if len(devs) > 1:
                raise ValueError(f"table {name!r}: columns on several "
                                 f"devices {sorted(map(str, devs))}")
            device = devs.pop() if devs else resolve_device(None)
        else:
            device = resolve_device(device)
        self.device = device
        cols: Dict[str, torch.Tensor] = {}
        host: Dict[str, np.ndarray] = {}
        n = None
        for f in schema.fields:
            if f.name not in columns:
                raise KeyError(f"missing column {f.name!r} for table {name!r}")
            sdt = _storage_dtype(f.dtype)
            c = columns[f.name]
            if isinstance(c, torch.Tensor):
                arr = c.to(device=device, dtype=_NP_TO_TORCH[sdt])
            else:
                h = np.array(c, dtype=sdt)   # a private copy: the mirror
                arr = torch.from_numpy(h).to(device)
                if h.ndim == 1:
                    host[f.name] = _frozen(h)
            if arr.ndim != 1:
                raise ValueError(f"column {f.name!r} must be 1-D, got shape {tuple(arr.shape)}")
            if n is None:
                n = int(arr.shape[0])
            elif int(arr.shape[0]) != n:
                raise ValueError(
                    f"column {f.name!r} has {arr.shape[0]} rows, expected {n}"
                )
            cols[f.name] = arr
        self.columns = cols
        self._host = host
        self._nrows = 0 if n is None else n

    # ---------------------------------------------------------------- basics
    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def row_bytes(self) -> int:
        return self.schema.row_bytes

    @property
    def wire_bytes(self) -> int:
        return self.nrows * self.row_bytes

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def host(self, name: str) -> np.ndarray:
        """Read-only numpy mirror of one column, copied from the device once
        and cached (the table is immutable)."""
        arr = self._host.get(name)
        if arr is None:
            arr = _frozen(self.columns[name].cpu().numpy())
            self._host[name] = arr
        return arr

    def to(self, device) -> "Table":
        """This table on ``device`` (itself when already there)."""
        device = resolve_device(device)
        if device == self.device:
            return self
        out = Table(self.name, self.schema, self.columns, device=device)
        out._host.update(self._host)
        return out

    def __repr__(self) -> str:
        return f"Table({self.name!r}, rows={self.nrows}, cols={list(self.schema.names)})"

    # ----------------------------------------------------------- constructors
    @staticmethod
    def from_columns(name: str, schema: Schema, device=None, **columns) -> "Table":
        return Table(name, schema, columns, device=device)

    @staticmethod
    def from_rows(name: str, schema: Schema, rows: Iterable[Mapping[str, object]],
                  device=None) -> "Table":
        rows = list(rows)
        cols = {
            f.name: np.asarray([r[f.name] for r in rows], dtype=_storage_dtype(f.dtype))
            if rows
            else np.asarray([], dtype=_storage_dtype(f.dtype))
            for f in schema.fields
        }
        return Table(name, schema, cols, device=device)

    def empty_like(self) -> "Table":
        return Table(
            self.name,
            self.schema,
            {f.name: np.asarray([], dtype=_storage_dtype(f.dtype)) for f in self.schema.fields},
            device=self.device,
        )

    # ------------------------------------------------------------- row access
    def row(self, i: int) -> Dict[str, object]:
        return {n: self.host(n)[i].item() for n in self.schema.names}

    def to_rows(self) -> List[Dict[str, object]]:
        host = {n: self.host(n) for n in self.schema.names}
        return [{n: host[n][i].item() for n in self.schema.names} for i in range(self.nrows)]

    # ------------------------------------------------------------- transforms
    def take(self, idx) -> "Table":
        """Rows at the non-negative host indices ``idx`` (moved to the
        device once per call). Columns already mirrored on the host keep a
        mirror, gathered on the host, so the result needs no copy back."""
        idx = np.asarray(idx, dtype=np.int64)
        didx = host_to_device(idx, self.device)
        out = Table(self.name, self.schema,
                    {n: torch.index_select(c, 0, didx) for n, c in self.columns.items()},
                    device=self.device)
        for n, h in self._host.items():
            out._host[n] = _frozen(h[idx])
        return out

    def filter_mask(self, mask) -> "Table":
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        keep = np.flatnonzero(np.asarray(mask))
        return self.take(keep)

    def head(self, k: int) -> "Table":
        return self.take(np.arange(min(k, self.nrows)))

    def select_columns(self, names: Sequence[str]) -> "Table":
        out = Table(self.name, self.schema.subset(names),
                    {n: self.columns[n] for n in names}, device=self.device)
        out._host.update({n: self._host[n] for n in names if n in self._host})
        return out

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        fields = tuple(
            dataclasses.replace(f, name=mapping.get(f.name, f.name)) for f in self.schema.fields
        )
        cols = {mapping.get(n, n): c for n, c in self.columns.items()}
        out = Table(self.name, Schema(fields), cols, device=self.device)
        out._host.update({mapping.get(n, n): h for n, h in self._host.items()})
        return out

    def with_column(self, field: Field, values) -> "Table":
        if self.schema.has(field.name):
            fields = tuple(field if f.name == field.name else f for f in self.schema.fields)
        else:
            fields = self.schema.fields + (field,)
        cols = dict(self.columns)
        cols[field.name] = values
        out = Table(self.name, Schema(fields), cols, device=self.device)
        for n, h in self._host.items():
            if n != field.name:
                out._host[n] = h
        return out

    def sort_by(self, keys: Sequence[str], descending: bool = False) -> "Table":
        if self.nrows == 0:
            return self
        arrs = [self.host(k) for k in reversed(list(keys))]
        order = np.lexsort(arrs)
        if descending:
            order = order[::-1]
        return self.take(order)

    def concat_rows(self, other: "Table") -> "Table":
        if self.schema.names != other.schema.names:
            raise ValueError("schema mismatch in concat")
        cols = {
            n: torch.cat([self.columns[n], other.columns[n].to(self.device)])
            for n in self.schema.names
        }
        return Table(self.name, self.schema, cols, device=self.device)

    # ------------------------------------------------------------- comparison
    def canonical_key(self) -> np.ndarray:
        """Row-set canonical form (sorted rows over sorted column names)."""
        names = sorted(self.schema.names)
        mat = np.stack([np.asarray(self.host(n), dtype=np.float64) for n in names], axis=1)
        if mat.shape[0] > 1:
            order = np.lexsort(tuple(mat[:, j] for j in reversed(range(mat.shape[1]))))
            mat = mat[order]
        return mat

    def same_rows(self, other: "Table", ordered: bool = False, atol: float = 1e-6) -> bool:
        """Semantic equality: same multiset (or sequence) of rows."""
        if sorted(self.schema.names) != sorted(other.schema.names):
            return False
        if self.nrows != other.nrows:
            return False
        if self.nrows == 0:
            return True
        if ordered:
            names = sorted(self.schema.names)
            a = np.stack([np.asarray(self.host(n), np.float64) for n in names], 1)
            b = np.stack([np.asarray(other.host(n), np.float64) for n in names], 1)
            return bool(np.allclose(a, b, atol=atol))
        return bool(np.allclose(self.canonical_key(), other.canonical_key(), atol=atol))
