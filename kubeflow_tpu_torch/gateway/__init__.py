"""Inference gateway: the Istio-ingress/Knative-activator analog, the
port of ``kubeflow_tpu/gateway`` on the standard library.

An L7 front door over N real ``ModelServer`` replicas — backend pool with
health probes + circuit breaking (``backends``), deterministic edge
routing with canary split and prefix/session affinity (``router``),
scale-from-zero request buffering (``activator``), per-tenant traffic
policy (``policy``), and the threaded proxy tying them together, with
mid-stream SSE failover (``server``). See README, "The port's gateway".
"""

from kubeflow_tpu_torch.gateway.activator import (
    ActivationTimeout,
    Activator,
    QueueOverflow,
)
from kubeflow_tpu_torch.gateway.backends import (
    Backend,
    BackendPool,
    BreakerConfig,
    CircuitBreaker,
)
from kubeflow_tpu_torch.gateway.policy import (
    PolicyEngine,
    RateLimited,
    RetryBudget,
    TenantPolicy,
    TokenBucket,
    TooManyInFlight,
)
from kubeflow_tpu_torch.gateway.router import (
    HashRing,
    RouteTable,
    ServiceRoute,
    affinity_key_of,
    canary_slot,
    pick_revision,
)
from kubeflow_tpu_torch.gateway.server import GatewayConfig, InferenceGateway

__all__ = [
    "ActivationTimeout",
    "Activator",
    "Backend",
    "BackendPool",
    "BreakerConfig",
    "CircuitBreaker",
    "GatewayConfig",
    "HashRing",
    "InferenceGateway",
    "PolicyEngine",
    "QueueOverflow",
    "RateLimited",
    "RetryBudget",
    "RouteTable",
    "ServiceRoute",
    "TenantPolicy",
    "TokenBucket",
    "TooManyInFlight",
    "affinity_key_of",
    "canary_slot",
    "pick_revision",
]
