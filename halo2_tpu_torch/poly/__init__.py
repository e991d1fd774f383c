"""Evaluation domains and the radix-2 NTT on torch tensors."""

from .._refpath import reference_dir

__path__.append(reference_dir("poly"))

from .domain import EvaluationDomain, get_domain  # noqa: E402

__all__ = ["EvaluationDomain", "get_domain"]
