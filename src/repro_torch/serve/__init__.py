"""Serving substrate of the port: the resident-model online clustering
service (the JAX package's ``serve/cluster_service.py``, DESIGN.md §14)."""

from repro_torch.serve.cluster_service import (
    AssignResult,
    ClusterService,
    DeadlineError,
    FittedModel,
    IngestError,
    IngestReceipt,
    ServiceConfig,
    ShedError,
)

__all__ = [
    "AssignResult",
    "ClusterService",
    "DeadlineError",
    "FittedModel",
    "IngestError",
    "IngestReceipt",
    "ServiceConfig",
    "ShedError",
]
