"""Degeneracy gating (the thesis's log-det gate)."""

from . import gate
from .gate import GateConfig, GateResult, logdet_gate

__all__ = ["gate", "GateConfig", "GateResult", "logdet_gate"]
