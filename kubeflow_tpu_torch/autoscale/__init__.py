"""Serving autoscaler (Knative-KPA analog) + cross-replica prefix-KV
transfer — the port of ``kubeflow_tpu/autoscale``, on threads and the
standard library: the control loop that makes the horizontal serving
plane (gateway + activator + ModelServer replicas) follow load.

- :mod:`kpa` — the pure recommender: stable/panic windows over a
  per-service concurrency target, scale-to-zero grace, rate limits;
- :mod:`signals` — scrape + fold the autoscaler inputs
  (``kft_server_inflight``, queue depths, activator parking);
- :mod:`autoscaler` — the tick-thread control loop wiring recommenders to
  actuators, kicked out-of-band by the activator's cold episodes;
- :mod:`fleet` — the actuator: replica lifecycle + gateway pool
  membership + prefix-KV rebalance around every remap;
- :mod:`kv_transfer` — plan/execute pulls of stored prefix KV from the
  previous ring owner to the new one.

The JAX package's ``subprocess_launcher`` waits for the port's replica
command line (ROADMAP queue 1 item 11).
"""

from kubeflow_tpu_torch.autoscale.autoscaler import ServingAutoscaler, TickResult
from kubeflow_tpu_torch.autoscale.fleet import ReplicaFleet
from kubeflow_tpu_torch.autoscale.kpa import KPAConfig, KPARecommender, Recommendation
from kubeflow_tpu_torch.autoscale.kv_transfer import (
    Transfer,
    owner_of,
    plan_rebalance,
    rebalance,
)
from kubeflow_tpu_torch.autoscale.signals import (
    GatewaySignalSource,
    ServiceSignals,
    parse_prom_text,
)

__all__ = [
    "GatewaySignalSource",
    "KPAConfig",
    "KPARecommender",
    "Recommendation",
    "ReplicaFleet",
    "ServiceSignals",
    "ServingAutoscaler",
    "TickResult",
    "Transfer",
    "owner_of",
    "parse_prom_text",
    "plan_rebalance",
    "rebalance",
]
