"""Shared helpers: paper-scale Slim Fly topologies are expensive to
build (q=17 => 578 routers), so tests share one instance per q."""

import functools

from repro.core import build_slimfly


@functools.lru_cache(maxsize=None)
def cached_slimfly(q: int, p=None):
    return build_slimfly(q) if p is None else build_slimfly(q, p=p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one "
        "(run with `pytest -m cuda` on the card)")
