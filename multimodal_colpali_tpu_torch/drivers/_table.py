"""Question tables and result CSVs for the experiment drivers, without pandas
(the card's machine has no pandas and no openpyxl).

The JAX drivers read their question table with ``utils/io.read_table``
(pandas), shuffle it with ``df.sample(frac=1, random_state=seed)`` and write
results with ``to_csv(index=False)``. :class:`Table` does the same on the
standard library and numpy:

- read: a ``.xlsx`` path reads the ``.csv`` beside it (what ``read_table``
  does where no Excel engine is installed; this module never reads Excel);
  every column is typed as pandas' C parser types it: int, float (an empty
  or NA cell is NaN, and makes an int column float), bool (``True`` /
  ``False`` and their lower and upper cases, with no missing cell), else
  strings, NaN for a missing cell;
- shuffle: ``RandomState(seed).choice(n, n, replace=False)``, which is the
  permutation pandas draws, or the global numpy state for a None seed;
- write: a header and one line a row, ``csv.QUOTE_MINIMAL``, ``"\\n"``
  line ends, floats by ``repr``, NaN as an empty cell.
"""

from __future__ import annotations

import csv
import io
import math
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

# pandas' default NA strings (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})


def _parse_int(s: str) -> Optional[int]:
    t = s.strip()
    if not t or not (t.lstrip("+-").isdigit()):
        return None
    return int(t)


def _parse_float(s: str) -> Optional[float]:
    if "_" in s:      # Python's float() takes digit separators, pandas does not
        return None
    try:
        return float(s)
    except ValueError:
        return None


def _column(cells: Sequence[str]) -> List[Any]:
    """One column's cells -> its values, typed as pandas types the column."""
    missing = [c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if present and all(_parse_int(c) is not None for c in present):
        if not any(missing):
            return [_parse_int(c) for c in cells]
        return [math.nan if m else float(_parse_int(c)) for c, m in zip(cells, missing)]
    if present and all(_parse_float(c) is not None for c in present):
        return [math.nan if m else _parse_float(c) for c, m in zip(cells, missing)]
    if present and all(c in _TRUE or c in _FALSE for c in present):
        return [math.nan if m else c in _TRUE for c, m in zip(cells, missing)]
    if not present:
        return [math.nan] * len(cells)
    return [math.nan if m else c for c, m in zip(cells, missing)]


def _cell(v: Any) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return _cell(v.item())
    return str(v)


class Table:
    """Named columns of equal length, in order; rows read as dicts."""

    def __init__(self, columns: Dict[str, List[Any]]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        self.columns = {k: list(v) for k, v in columns.items()}

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, name: str) -> List[Any]:
        return self.columns[name]

    def rows(self) -> Iterator[Dict[str, Any]]:
        """Each row as ``{column: value}`` (``iterrows``' values)."""
        names = list(self.columns)
        for i in range(len(self)):
            yield {k: self.columns[k][i] for k in names}

    def take(self, order: Sequence[int]) -> "Table":
        return Table({k: [v[i] for i in order] for k, v in self.columns.items()})

    def sample(self, seed: Optional[int] = None) -> "Table":
        """``df.sample(frac=1, random_state=seed).reset_index(drop=True)``."""
        n = len(self)
        rs = np.random.mtrand._rand if seed is None else np.random.RandomState(seed)
        return self.take([int(i) for i in rs.choice(n, size=n, replace=False)])

    def with_column(self, name: str, values: Any) -> "Table":
        """A copy with ``name`` set to ``values`` (a list, or one value for
        every row), appended or replaced in place as pandas assigns."""
        vals = list(values) if isinstance(values, (list, tuple)) else [values] * len(self)
        cols = dict(self.columns)
        cols[name] = vals
        return Table(cols)

    def to_csv(self, path: Any = None) -> str:
        """``df.to_csv(path, index=False)``; returns the text."""
        buf = io.StringIO()
        w = csv.writer(buf, quoting=csv.QUOTE_MINIMAL, lineterminator="\n")
        w.writerow(list(self.columns))
        for row in self.rows():
            w.writerow([_cell(v) for v in row.values()])
        text = buf.getvalue()
        if path is not None:
            with open(path, "w", newline="", encoding="utf-8") as f:
                f.write(text)
        return text

    @classmethod
    def from_csv_text(cls, text: str) -> "Table":
        rows = list(csv.reader(io.StringIO(text)))
        if not rows:
            raise ValueError("a CSV without a header")
        header, body = rows[0], [r for r in rows[1:] if r]
        cells = {h: [r[j] if j < len(r) else "" for r in body] for j, h in enumerate(header)}
        return cls({h: _column(c) for h, c in cells.items()})


def read_table(path: str) -> Table:
    """The question table at ``path``: a ``.csv``, or for a ``.xlsx`` the
    ``.csv`` of the same stem beside it (utils/io.py:26-39 without an Excel
    engine)."""
    p = Path(path)
    if p.suffix.lower() in (".xlsx", ".xls"):
        csv_alt = p.with_suffix(".csv")
        if csv_alt.exists():
            p = csv_alt
        elif p.exists():
            raise RuntimeError(f"{p} is Excel, which this port does not read, and {csv_alt} "
                               f"does not exist")
        else:
            raise FileNotFoundError(path)
    with open(p, newline="", encoding="utf-8") as f:
        return Table.from_csv_text(f.read())
