"""Rows ↔ CSV files, interchangeable with the JAX package's pandas files.

A builder's result is a list of dicts, one per row, in column order. The
file is what ``pandas.DataFrame(rows).to_csv(path, index=False)`` writes
(``index=True`` adds pandas' unnamed index column): a header line, ``\\n``
line ends, ``None`` as an empty field and floats as ``repr``. Reading parses
each field back as an int, a float, ``None`` (empty) or the string itself, so
the JAX package's files (where pandas writes a column of ints with gaps as
floats, ``1.0``) read into rows that compare equal.
"""
from __future__ import annotations

import csv
import os


def write_rows(path: str, rows: list[dict], index: bool = False) -> str:
    """Write ``rows`` to ``path`` (its directory made), columns in the first row's order."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    columns = list(rows[0]) if rows else []
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(([""] if index else []) + columns)
        for i, row in enumerate(rows):
            values = [_field(row[c]) for c in columns]
            writer.writerow(([i] if index else []) + values)
    return path


def _field(value):
    if value is None:
        return ""
    if isinstance(value, (int, str)):
        return value
    return float(value)  # numpy and torch scalars too; csv writes repr()


def _parse(text: str):
    if text == "":
        return None
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def read_rows(path: str, index_col=None) -> list[dict]:
    """Rows of a CSV written by :func:`write_rows` or by pandas; ``index_col=0``
    drops the leading index column, as ``pandas.read_csv(path, index_col=0)``
    takes it out of the columns."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        keep = [i for i in range(len(header)) if i != index_col]
        return [{header[i]: _parse(line[i]) for i in keep} for line in reader]
