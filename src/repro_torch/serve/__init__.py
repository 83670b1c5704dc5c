"""Serving substrate of the port: the batched prefill+decode engine over the
model zoo (the JAX package's ``serve/engine.py``), and the resident-model
online clustering service (``serve/cluster_service.py``, DESIGN.md §14)."""

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
# the engine is importable from here too; ``__all__`` lists the service's
# names only, as the JAX package's ``repro.serve`` does
from repro_torch.serve.engine import Completion, Request, ServeEngine  # noqa: F401

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
