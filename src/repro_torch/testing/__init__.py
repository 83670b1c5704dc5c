"""Test-support machinery importable from production wiring points.

``repro_torch.testing.faults`` is the deterministic fault injector behind
the ``REPRO_FAULTS`` variable; the streaming executor consults it where it
produces chunks, at no cost when no plan is installed."""

from repro_torch.testing.faults import FaultPlan, InjectedFault, active, clear, inject, install

__all__ = ["FaultPlan", "InjectedFault", "active", "clear", "inject", "install"]
