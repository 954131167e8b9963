"""Observability helpers of the port. Only the metric-safe tenant and tier
labels are ported so far (:mod:`.timeline`)."""
from perceiver_io_tpu_torch.observability.timeline import tenant_label, tier_label

__all__ = ["tenant_label", "tier_label"]
