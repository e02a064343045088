"""The synthetic data pipeline, as in `repro.data`."""

from .pipeline import Prefetcher, SyntheticLM

__all__ = ["Prefetcher", "SyntheticLM"]
