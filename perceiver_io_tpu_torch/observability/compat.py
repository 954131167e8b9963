"""Compat reader for ``metrics.jsonl`` across the schema fix.

Historical rows mixed two shapes in one file with no discriminator:

- scalar rows   ``{"step": 5, "train/loss": 2.1, "train/lr": 1e-4}``
- text rows     ``{"step": 5, "samples/generated": "..."}``  (``log_text``)

— so every parser had to type-sniff each value. The fixed schema keeps
scalar rows flat (every non-``step`` value is a float — documented
invariant) and namespaces text events under one ``"text"`` key:

- scalar rows   ``{"step": 5, "train/loss": 2.1}``           (unchanged)
- text rows     ``{"step": 5, "text": {"samples/generated": "..."}}``

:func:`read_metrics_jsonl` normalizes BOTH generations to
``{"step", "metrics", "text"}`` rows, so downstream tooling (longrun's
analyzer, notebook plots) reads old and new files through one function and
never sniffs again.
"""
from __future__ import annotations

import json
from typing import List


def normalize_row(row: dict) -> dict:
    """One raw metrics.jsonl row → ``{"step", "metrics", "text"}``.

    New-schema text rows have the ``"text"`` namespace; old-schema text rows
    are detected by value type (the sniff this module exists to retire —
    done once, here, instead of in every consumer)."""
    step = row.get("step")
    metrics = {}
    text = dict(row.get("text") or {})
    for key, value in row.items():
        if key in ("step", "text"):
            continue
        if isinstance(value, str):
            text[key] = value  # old-schema text row
        else:
            metrics[key] = float(value)
    return {"step": step, "metrics": metrics, "text": text}


def read_metrics_jsonl(path: str) -> List[dict]:
    """Parse a metrics.jsonl (old or new schema) into normalized rows,
    skipping blank/torn lines."""
    rows: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                raw = json.loads(line)
            except json.JSONDecodeError:
                continue
            rows.append(normalize_row(raw))
    return rows
