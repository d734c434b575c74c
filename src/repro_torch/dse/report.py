"""Sweep result reporting: tidy tables, Pareto fronts, JSON/CSV export.
A copy of ``repro.dse.report``.

Rows are plain dicts (one per design point, axes merged with extracted
stats — the output of ``runner.run_sweep``), so everything here is
host-side bookkeeping over scalars.
"""
from __future__ import annotations

import csv
import json
from typing import Iterable, Mapping, Sequence

MIN, MAX = "min", "max"


def _as_scalar(v):
    try:
        f = float(v)
        return int(f) if f.is_integer() else f
    except (TypeError, ValueError):
        return v


def tidy(rows: Iterable[Mapping]) -> list[dict]:
    """Normalize rows: plain python scalars, union of keys, stable order."""
    rows = [dict(r) for r in rows]
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    return [{k: _as_scalar(r.get(k)) for k in keys} for r in rows]


def score_vector(row: Mapping, objectives: Mapping[str, str]) -> tuple:
    """Canonical "higher is better" objective vector of one row."""
    return tuple((1.0 if d == MAX else -1.0) * float(row[c])
                 for c, d in objectives.items())


def _dominates_scores(a: tuple, b: tuple) -> bool:
    """``a`` dominates ``b`` on canonical higher-is-better vectors."""
    return (all(x >= y for x, y in zip(a, b))
            and any(x > y for x, y in zip(a, b)))


def dominates(a: Mapping, b: Mapping,
              objectives: Mapping[str, str]) -> bool:
    """Whether row ``a`` dominates row ``b`` under ``objectives``
    ({column: 'min'|'max'}): at least as good on every objective and
    strictly better on one.  NaN objectives dominate nothing and are
    dominated by nothing (NaN compares false), matching
    :func:`pareto_front`'s exclusion rule.  Shared by the front
    extraction below and the search promoters
    (:mod:`repro_torch.dse.search`)."""
    return _dominates_scores(score_vector(a, objectives),
                             score_vector(b, objectives))


def pareto_front(rows: Sequence[Mapping],
                 objectives: Mapping[str, str]) -> list[dict]:
    """Non-dominated rows under ``objectives`` ({column: 'min'|'max'}).

    A row is dominated when some other row is at least as good on every
    objective and strictly better on one.  Ties/duplicates keep the first
    occurrence.  Rows are returned in input order.  Rows with a NaN in
    any objective are excluded — NaN compares false against everything,
    so they could neither dominate nor be dominated and would otherwise
    pollute every front (a NaN metric usually means the config never
    finished; it is not a trade-off point).

    Sort-based fast path: candidates are visited in descending
    lexicographic score order, in which a dominator always precedes
    everything it dominates — so each candidate is checked against the
    current front only (O(n·|front| + n log n), not all-pairs O(n²)).
    """
    assert objectives and all(d in (MIN, MAX) for d in objectives.values())

    scored = [(s, i) for i, r in enumerate(rows)
              for s in [score_vector(r, objectives)]
              if not any(v != v for v in s)]
    # descending lex by score; ties resolved to input order so the first
    # occurrence of a duplicate vector is the one visited (and kept)
    order = sorted(range(len(scored)),
                   key=lambda k: (tuple(-v for v in scored[k][0]),
                                  scored[k][1]))
    front_scores: list[tuple] = []
    front_idx: list[int] = []
    seen: set[tuple] = set()
    for k in order:
        s, i = scored[k]
        if s in seen:
            continue
        if not any(_dominates_scores(fs, s) for fs in front_scores):
            front_scores.append(s)
            front_idx.append(i)
            seen.add(s)
    return [dict(rows[i]) for i in sorted(front_idx)]


def to_json(rows: Iterable[Mapping], path: str) -> None:
    with open(path, "w") as fh:
        json.dump(tidy(rows), fh, indent=2, sort_keys=True)
        fh.write("\n")


def to_csv(rows: Iterable[Mapping], path: str) -> None:
    rows = tidy(rows)
    if not rows:
        open(path, "w").close()
        return
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def format_table(rows: Sequence[Mapping], floatfmt: str = "{:.4g}") -> str:
    """Fixed-width text table (for example scripts / logs)."""
    rows = tidy(rows)
    if not rows:
        return "(no rows)"
    cols = list(rows[0])
    cells = [[c for c in cols]]
    for r in rows:
        cells.append([
            floatfmt.format(r[c]) if isinstance(r[c], float) else str(r[c])
            for c in cols])
    widths = [max(len(row[j]) for row in cells) for j in range(len(cols))]
    lines = ["  ".join(c.rjust(w) for c, w in zip(row, widths))
             for row in cells]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
