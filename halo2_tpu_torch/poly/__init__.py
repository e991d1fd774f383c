"""Evaluation domains and the radix-2 NTT on torch tensors."""

from .domain import EvaluationDomain, get_domain

__all__ = ["EvaluationDomain", "get_domain"]
