"""Metric-safe labels for tenants and priority tiers.

A copy of ``tenant_label`` and ``tier_label`` from
``perceiver_io_tpu/observability/timeline.py`` (pure host code; the port
keeps its own copy so that it imports nothing of the JAX package). The step
timeline itself is not ported yet.
"""
from __future__ import annotations

import re
from typing import Optional

_LABEL_RE = re.compile(r"[^0-9A-Za-z_]")


def tenant_label(tenant: Optional[str]) -> str:
    """Metric-safe label for a tenant id: ``None`` (untagged traffic) maps
    to ``"default"``; anything else keeps ``[0-9A-Za-z_]`` and replaces the
    rest with ``_``. Collisions after sanitization share a label."""
    if tenant is None:
        return "default"
    out = _LABEL_RE.sub("_", str(tenant))
    return out or "default"


def tier_label(tier: int) -> str:
    """Metric-safe label for a priority tier: negative tiers spell the sign
    out (``neg1``), as the ``kv_preemptions_tier_*`` counters name them."""
    tier = int(tier)
    return f"neg{-tier}" if tier < 0 else str(tier)
