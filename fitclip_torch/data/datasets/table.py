"""CSV and TSV metadata read as the JAX package's readers read it with
``pandas.read_csv`` and its defaults, on the standard library's ``csv``.

A column is typed as pandas infers it: bool if every present value is a
boolean word, int if every present value is an integer (float if one is
missing), float if every present value is a number, else str. A column named
in ``str_columns`` (``dtype={name: str}``) stays str. Pandas' default NA
strings read as NaN in every column, quoting is ``csv``'s default (the same as
pandas'), and blank lines are skipped.
"""

import csv
import math
import re
from typing import Dict, List, Optional, Sequence

NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\Z|[+-]?(inf|Inf|INF|infinity|Infinity)\Z")


def _typed(values: List[str]) -> list:
    present = [v for v in values if v not in NA_VALUES]
    if present and all(v in _TRUE or v in _FALSE for v in present):
        return [math.nan if v in NA_VALUES else v in _TRUE for v in values]
    if all(_INT.match(v) for v in present):
        if len(present) == len(values):
            return [int(v) for v in values]
        return [math.nan if v in NA_VALUES else float(int(v)) for v in values]
    if all(_FLOAT.match(v) or _INT.match(v) for v in present):
        return [math.nan if v in NA_VALUES else float(v) for v in values]
    return [math.nan if v in NA_VALUES else v for v in values]


def read_table(path, names: Optional[Sequence[str]] = None, delimiter: str = ",",
               str_columns: Sequence[str] = ()) -> Dict[str, list]:
    """{column: its values in row order}. ``names`` gives the columns of a file
    without a header row (``pd.read_csv(names=...)``); otherwise the first
    row names them."""
    with open(path, newline="", encoding="utf-8") as file:
        rows = [row for row in csv.reader(file, delimiter=delimiter) if row]
    if names is None:
        names, rows = rows[0], rows[1:]
    columns = {name: [row[i] if i < len(row) else "" for row in rows]
               for i, name in enumerate(names)}
    return {name: ([math.nan if v in NA_VALUES else v for v in values] if name in str_columns
                   else _typed(values))
            for name, values in columns.items()}
