"""Serving layer of the port (counterpart of ``perceiver_io_tpu/serving``):

- :class:`ServingEngine`: shape bucketing and continuous micro-batching at
  generation granularity.
- :class:`SlotServingEngine`: token-granular continuous batching over a
  persistent multi-slot decode state, dense or paged KV (K4 on the card).
- :class:`FleetRouter`: N supervised engine replicas behind one router,
  with circuit breakers, crash and hang detection and exactly-once
  failover that replays in-flight requests from their prompts.
- :class:`FleetAutoscaler`: the SLO-driven replica-count loop over a
  fleet, with zero-downtime scale-down.
- :class:`StreamingGateway`: the stdlib asyncio HTTP/1.1 front end with
  per-token SSE / JSON-lines streaming and disconnect cancellation.

The serving mesh (JAX's ``ServingMeshSpec``, ``ServingSharding``,
``MeshGroupAllocator``, ``fleet_mesh_specs``) is not ported yet
(``ROADMAP.md`` A.6).
"""
from perceiver_io_tpu_torch.reliability import QueueFull
from perceiver_io_tpu_torch.serving.autoscaler import LADDER, FleetAutoscaler
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.engine import HEALTH_KEYS, ServeRequest, ServingEngine
from perceiver_io_tpu_torch.serving.fleet import (
    CircuitBreaker,
    FleetRequest,
    FleetRouter,
    Replica,
)
from perceiver_io_tpu_torch.serving.gateway import StreamingGateway
from perceiver_io_tpu_torch.serving.kv_pool import KVPagePool, PoolExhausted, PrefixBlockIndex
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

__all__ = [
    "BucketTable",
    "CircuitBreaker",
    "FleetAutoscaler",
    "FleetRequest",
    "FleetRouter",
    "LADDER",
    "HEALTH_KEYS",
    "KVPagePool",
    "PrefixBlockIndex",
    "PoolExhausted",
    "QueueFull",
    "Replica",
    "ServeRequest",
    "ServingEngine",
    "SlotServingEngine",
    "StreamingGateway",
]
