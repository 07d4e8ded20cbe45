"""A minimal column table: the port's stand-in for the pandas DataFrame.

The JAX package's data layer takes and returns ``pd.DataFrame``s.  The
port needs no pandas: a :class:`Table` holds equal-length numpy columns
by name and offers the few operations the data layer uses, each with the
row order of the pandas operation it replaces:

- :meth:`Table.take`, :meth:`Table.filter`, :meth:`Table.assign`,
  :meth:`Table.select` (row and column selection, new columns);
- :meth:`Table.sort`: a stable multi-key sort (``sort_values(...,
  kind="stable")``);
- :func:`group_index` and :func:`groups`: groups in sorted key order
  (``groupby``'s default), and on them :meth:`Table.group_first`, :meth:`Table.group_argmin`
  (``groupby(...).r.idxmin()``) and :meth:`Table.group_nunique`
  (``transform("nunique")``);
- :func:`inner_join`: ``merge(how="inner")`` with the left table's row
  order, each left row followed by its matches in the right table's
  order;
- :func:`read_csv`: ``pd.read_csv``'s column types (int64 where every
  field is an integer, so TrackML's particle ids above 2^53 stay exact;
  float64 where every field is a number) and its float bits
  (:func:`parse_floats`).

Everything stays on the host, as the JAX package's parsing and selection
do.
"""

from __future__ import annotations

import csv
import gzip
import io
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np


class Table:
    """Equal-length numpy columns by name, in insertion order."""

    def __init__(self, columns: Mapping[str, object] = ()):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, col in dict(columns).items():
            col = np.asarray(col)
            if col.ndim != 1:
                raise ValueError(f"column {name!r} is not one-dimensional")
            if n is not None and len(col) != n:
                raise ValueError(f"column {name!r} has {len(col)} rows, "
                                 f"not {n}")
            n = len(col)
            self._cols[name] = col
        self._n = 0 if n is None else n

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __repr__(self) -> str:
        return f"Table({self._n} rows: {', '.join(self._cols)})"

    def take(self, idx) -> "Table":
        """The rows at positions ``idx``, in that order."""
        idx = np.asarray(idx, dtype=np.int64)
        return Table({k: v[idx] for k, v in self._cols.items()})

    def filter(self, mask) -> "Table":
        """The rows where ``mask`` is true, in their order."""
        return self.take(np.flatnonzero(np.asarray(mask, dtype=bool)))

    def select(self, names: Sequence[str]) -> "Table":
        """The named columns, in the order given."""
        return Table({k: self._cols[k] for k in names})

    def assign(self, **cols) -> "Table":
        """A copy with ``cols`` added or replaced (a scalar fills the
        column, as ``DataFrame.assign`` does)."""
        out = dict(self._cols)
        for k, v in cols.items():
            v = np.asarray(v)
            out[k] = np.full(self._n, v) if v.ndim == 0 else v
        return Table(out)

    def rows(self, names: Sequence[str], dtype) -> np.ndarray:
        """``[n, len(names)]`` of the named columns in ``dtype``
        (``df[names].to_numpy(dtype)``)."""
        if not names:
            return np.zeros((self._n, 0), dtype)
        return np.stack([self._cols[k].astype(dtype) for k in names], axis=1)

    def sort(self, keys: Sequence[str]) -> "Table":
        """Rows in stable lexicographic order of ``keys`` (the first key
        major)."""
        return self.take(np.lexsort([self._cols[k] for k in keys[::-1]]))

    def group_first(self, keys: Sequence[str]) -> "Table":
        """One row a group of ``keys``, in sorted key order: the keys and,
        for each other column, the group's first value, its first that is
        not NaN for a float column (``groupby(keys).first()``)."""
        order, gid, first = group_index(self, keys)
        out = {k: self._cols[k][order[first]] for k in keys}
        for k, v in self._cols.items():
            if k in keys:
                continue
            vs = v[order]
            if vs.dtype.kind == "f":
                ok = ~np.isnan(vs)
                pos = np.where(ok, np.arange(len(vs)), len(vs))
                firsts = np.minimum.reduceat(pos, first) if len(vs) else pos
                got = np.full(len(first), np.nan, vs.dtype)
                has = firsts < len(vs)
                got[has] = vs[firsts[has]]
                out[k] = got
            else:
                out[k] = vs[first]
        return Table(out)

    def group_argmin(self, keys: Sequence[str], value: str) -> np.ndarray:
        """Row positions of the first minimal ``value`` of each group of
        ``keys``, groups in sorted key order
        (``groupby(keys)[value].idxmin()`` on a default index)."""
        cols = [self._cols[value]] + [self._cols[k] for k in keys[::-1]]
        order = np.lexsort(cols)   # stable: equal minima keep row order
        if len(order) == 0:
            return order
        key_sorted = [self._cols[k][order] for k in keys]
        new = np.zeros(len(order), bool)
        new[0] = True
        for ks in key_sorted:
            new[1:] |= ks[1:] != ks[:-1]
        return order[new]

    def group_nunique(self, keys: Sequence[str], value: str) -> np.ndarray:
        """Per row, the number of distinct ``value``s in its group of
        ``keys`` (``groupby(keys)[value].transform("nunique")``)."""
        n = self._n
        if n == 0:
            return np.zeros(0, np.int64)
        order, gid, first = group_index(self, keys)
        v = self._cols[value][order]
        # distinct (group, value) pairs: sort by value within group
        o2 = np.lexsort((v, gid))
        g2, v2 = gid[o2], v[o2]
        new = np.ones(n, bool)
        new[1:] = (g2[1:] != g2[:-1]) | (v2[1:] != v2[:-1])
        counts = np.bincount(g2[new], minlength=len(first))
        out = np.empty(n, np.int64)
        out[order] = counts[gid]
        return out


def group_index(table: Table, keys: Sequence[str]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(order, gid, first)``: a stable sort of the rows by ``keys``, the
    group of each sorted row (0, 1, ... in sorted key order), and the
    first sorted position of each group."""
    order = np.lexsort([table[k] for k in keys[::-1]])
    n = len(order)
    new = np.zeros(n, bool)
    if n:
        new[0] = True
        for k in keys:
            ks = table[k][order]
            new[1:] |= ks[1:] != ks[:-1]
    first = np.flatnonzero(new)
    return order, np.cumsum(new) - 1, first


def groups(table: Table, keys: Sequence[str]):
    """``(key, rows)`` for each group of ``keys`` in sorted key order
    (``for key, rows in df.groupby(keys)``): ``key`` the tuple of the
    group's key values, ``rows`` its rows in their order."""
    order, _, first = group_index(table, keys)
    bounds = np.append(first, len(order))
    for g in range(len(first)):
        rows = order[bounds[g]:bounds[g + 1]]
        yield tuple(table[k][rows[0]] for k in keys), table.take(rows)


def first_appearance(values: np.ndarray) -> np.ndarray:
    """The distinct ``values`` in order of first appearance
    (``Series.drop_duplicates().values``)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def drop_duplicates(table: Table, keys: Sequence[str]) -> Table:
    """Rows whose ``keys`` were not seen in an earlier row, in order
    (``drop_duplicates(keys)``, keep first)."""
    order, _, first = group_index(table, keys)
    return table.take(np.sort(order[first]))


def concat(tables: Iterable[Table]) -> Table:
    """Rows of ``tables`` one after the other (``pd.concat(...,
    ignore_index=True)`` of tables with the same columns)."""
    tables = list(tables)
    if not tables:
        return Table()
    names = tables[0].columns
    for t in tables[1:]:
        if set(t.columns) != set(names):
            raise ValueError(f"columns differ: {names} and {t.columns}")
    return Table({k: np.concatenate([t[k] for t in tables]) for k in names})


def inner_join(left: Table, right: Table, on: Sequence[str],
               suffixes: Tuple[str, str] = ("_x", "_y")) -> Table:
    """``left.merge(right, on=on, how="inner")``: every left row with each
    right row of equal keys, in the left table's row order and, for one
    left row, the right table's; the key columns once, other columns of
    one name in both suffixed."""
    on = list(on)
    r_order = group_index(right, on)[0]
    li, ri = _match(left, right, on, r_order)
    sx, sy = suffixes
    out = {}
    for k in left.columns:
        name = k + sx if k not in on and k in right.columns else k
        out[name] = left[k][li]
    for k in right.columns:
        if k not in on:
            out[k + sy if k in left.columns else k] = right[k][ri]
    return Table(out)


def _match(left: Table, right: Table, on, r_order):
    """Positions ``(li, ri)`` of the joined rows of :func:`inner_join`."""
    n_left = len(left)
    if n_left == 0 or len(right) == 0:
        z = np.zeros(0, np.int64)
        return z, z
    # one id per distinct key over both tables, by a joint stable sort
    both = {k: np.concatenate([left[k], right[k]]) for k in on}
    order, gid, _ = group_index(Table(both), on)
    key_id = np.empty(len(order), np.int64)
    key_id[order] = gid
    l_id, r_id = key_id[:n_left], key_id[n_left:]
    r_sorted = r_id[r_order]                       # ascending ids
    lo = np.searchsorted(r_sorted, l_id, side="left")
    hi = np.searchsorted(r_sorted, l_id, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(n_left), counts)
    starts = np.repeat(lo - np.cumsum(counts) + counts, counts)
    ri = r_order[starts + np.arange(len(li))]
    return li, ri


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

# 1e0 ... 1e308 as double literals, the table pandas' parser scales by
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_MAX_DIGITS = 17


def _ascii(strings) -> np.ndarray:
    """``strings`` (str or bytes) as a contiguous numpy bytes array,
    stripped of surrounding whitespace; non-ASCII text raises
    ``ValueError``."""
    try:
        raw = np.ascontiguousarray(np.asarray(strings, dtype="S"))
    except UnicodeEncodeError as err:
        raise ValueError("non-ASCII characters in a numeric column") from err
    if raw.size and raw.itemsize:
        m = _char_matrix(raw)
        if ((m <= ord(" ")) & (m > 0)).any():
            raw = np.char.strip(raw)
    return raw


def _char_matrix(raw: np.ndarray) -> np.ndarray:
    """``[n, width]`` uint8 of a bytes array, zero-padded."""
    width = max(raw.itemsize, 1)
    return np.frombuffer(np.ascontiguousarray(raw, dtype=f"S{width}").tobytes(),
                         np.uint8).reshape(len(raw), width)


def parse_floats(strings) -> np.ndarray:
    """float64 of decimal strings (str or bytes) with the bits
    ``pd.read_csv``'s default parser gives them: the first 17 digits
    (leading zeros included) accumulated in a double (``number * 10 +
    digit``), then one multiplication or division by a power of ten.  For
    at most 15 digits and at most 22 decimals, with no exponent, that is
    the correctly rounded value, which numpy's conversion gives; other
    strings (a shortest repr of a double can have 17 digits) go through
    :func:`_parse_floats_as_pandas`.  Strings outside
    ``[+-]digits[.digits][(e|E)[+-]digits]`` (``nan``, ``inf``) are parsed
    by ``float``; an empty string is NaN."""
    raw = _ascii(strings)
    n = len(raw)
    out = np.empty(n, np.float64)
    if n == 0:
        return out
    m = _char_matrix(raw)
    dig = (m >= 48) & (m <= 57)
    dot = m == ord(".")
    sign = (m[:, 0] == ord("-")) | (m[:, 0] == ord("+"))
    other = ~(dig | dot | (m == 0))
    other[:, 0] &= ~sign
    n_dig = dig.sum(1)
    n_dec = (dig & (np.cumsum(dot, axis=1) > 0)).sum(1)
    fast = (~other.any(1) & (dot.sum(1) <= 1) & (n_dig >= 1)
            & (n_dig <= 15) & (n_dec <= 22))
    out[fast] = raw[fast].astype(np.float64)
    slow = np.flatnonzero(~fast)
    if len(slow):
        out[slow] = _parse_floats_as_pandas(raw[slow])
    return out


def _parse_floats_as_pandas(raw: np.ndarray) -> np.ndarray:
    """:func:`parse_floats` of any stripped bytes strings, character by
    character (one vector step a character position) as pandas' parser
    reads them."""
    n = len(raw)
    out = np.empty(n, np.float64)
    m = _char_matrix(raw)
    width = m.shape[1]
    number = np.zeros(n, np.float64)
    n_dig = np.zeros(n, np.int64)
    n_dec = np.zeros(n, np.int64)
    exponent = np.zeros(n, np.int64)
    e_val = np.zeros(n, np.int64)
    e_neg = np.zeros(n, bool)
    e_dig = np.zeros(n, np.int64)
    negative = m[:, 0] == ord("-")
    # phase: 1 integer digits, 2 decimals, 3 after e, 4 exponent digits,
    # 5 done; -1 not of the form above
    phase = np.ones(n, np.int8)
    start = np.where((m[:, 0] == ord("-")) | (m[:, 0] == ord("+")), 1, 0)
    for k in range(width):
        c = m[:, k]
        live = (k >= start) & (phase > 0) & (phase < 5)
        digit = (c >= 48) & (c <= 57)
        d = c.astype(np.int64) - 48
        end = c == 0
        is_e = (c == ord("e")) | (c == ord("E"))
        # integer digits
        p1 = live & (phase == 1)
        acc = p1 & digit & (n_dig < _MAX_DIGITS)
        number = np.where(acc, number * 10.0 + d, number)
        exponent += p1 & digit & (n_dig >= _MAX_DIGITS)
        n_dig += acc
        # decimals
        p2 = live & (phase == 2)
        acc2 = p2 & digit & (n_dig < _MAX_DIGITS)
        number = np.where(acc2, number * 10.0 + d, number)
        n_dig += acc2
        n_dec += acc2
        # exponent sign, then digits
        p3 = live & (phase == 3)
        sign = p3 & ((c == ord("-")) | (c == ord("+")))
        e_neg |= p3 & (c == ord("-"))
        p4 = live & ((phase == 4) | (p3 & digit))
        acc4 = p4 & digit & (e_dig < _MAX_DIGITS)
        e_val = np.where(acc4, e_val * 10 + d, e_val)
        e_dig += acc4
        new = phase.copy()
        new[(p1 | p2) & end] = 5
        new[p1 & (c == ord("."))] = 2
        new[(p1 | p2) & is_e] = 3
        new[sign] = 4
        new[p3 & digit] = 4
        new[p4 & end & (e_dig > 0)] = 5
        bad = ((p1 & ~(digit | end | is_e | (c == ord("."))))
               | (p2 & ~(digit | end | is_e))
               | (p3 & ~(digit | sign)) | (p4 & ~(digit | end)))
        new[bad] = -1
        phase = new
    phase[(phase == 1) | (phase == 2) | ((phase == 4) & (e_dig > 0))] = 5
    ok = (phase == 5) & (n_dig > 0)
    exponent = exponent - n_dec + np.where(e_neg, -e_val, e_val)
    number = np.where(negative, -number, number)
    with np.errstate(over="ignore"):
        big = exponent > 308
        pos = (exponent > 0) & ~big
        tiny = exponent < -616
        sub = (exponent < -308) & ~tiny
        neg = (exponent <= 0) & (exponent >= -308)
        res = np.empty(n, np.float64)
        res[big] = np.where(number[big] < 0, -np.inf, np.inf)
        res[pos] = number[pos] * _POW10[exponent[pos]]
        res[tiny] = 0.0
        res[sub] = (number[sub] / _POW10[-308 - exponent[sub]]) / _POW10[308]
        res[neg] = number[neg] / _POW10[-exponent[neg]]
    out[ok] = res[ok]
    for i in np.flatnonzero(~ok):
        out[i] = float(raw[i]) if raw[i] else np.nan
    return out


def column_from_fields(fields) -> np.ndarray:
    """One CSV column (str or bytes fields) as ``pd.read_csv`` types it:
    int64 when every field is an integer, float64 when every field is a
    number (or empty, NaN), bool for ``True``/``False``, else Python
    strings (an object array)."""
    try:
        raw = _ascii(fields)
    except ValueError:
        raw = None
    if raw is not None:
        try:
            return raw.astype(np.int64)
        except (ValueError, OverflowError):
            pass
        if len(raw) and np.isin(raw, (b"True", b"False")).all():
            return raw == b"True"
        try:
            return parse_floats(raw)
        except ValueError:
            pass
    return np.array([f.decode() if isinstance(f, bytes) else str(f)
                     for f in fields], dtype=object)


def column_from_values(values: Sequence) -> np.ndarray:
    """One column of Python values as the DataFrame constructor types it:
    int64 for ints, float64 for numbers, bool for bools, else objects
    (lists stay lists, one an entry)."""
    if all(isinstance(v, bool) for v in values):
        return np.asarray(values, dtype=bool)
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
           for v in values):
        return np.asarray(values, dtype=np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, bool) for v in values):
        return np.asarray(values, dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def read_csv(path: str) -> Table:
    """A CSV file with a header line (``.gz`` read through ``gzip``) as a
    :class:`Table`, each column typed as ``pd.read_csv`` types it
    (:func:`column_from_fields`)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    header, _, body = data.partition(b"\n")
    names = [h.strip().decode() for h in header.rstrip(b"\r").split(b",")]
    if b'"' in data:
        rows = [r for r in csv.reader(io.StringIO(body.decode())) if r]
        cols = list(zip(*rows)) if rows else [()] * len(names)
        return Table({name: column_from_fields(list(col))
                      for name, col in zip(names, cols)})
    lines = [ln for ln in body.replace(b"\r", b"").split(b"\n") if ln]
    fields = b",".join(lines).split(b",") if lines else []
    if len(fields) != len(lines) * len(names):
        raise ValueError(f"{path}: rows of unequal length")
    cells = np.array(fields, dtype="S").reshape(len(lines), len(names))
    return Table({name: column_from_fields(cells[:, i])
                  for i, name in enumerate(names)})
