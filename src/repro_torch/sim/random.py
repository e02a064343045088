"""The engines' random source, named by cycle and stream.

The reference draws from `jax.random` on a key schedule: the open loop
splits its key every cycle into ``key, k_inj, k_dst, k_rt``
(src/repro/sim/engine.py:652), the closed loop into ``key, k_rt``
(src/repro/sim/workloads/closed_loop.py:310).  torch has no threefry,
so the port asks an explicit source for each draw by its cycle and
stream name instead:

- ``inj``:   the open loop's Bernoulli injection coins;
- ``dst``:   the traffic pattern's raw destination draw (uniform, shift);
- ``route``: the Valiant intermediates of VAL and the candidates of UGAL.

Only raw values are drawn; every transform on top of them (uniform's
skip-self, shift's coin, VAL's and UGAL's bumps) is the port's own code.

- `TorchSource` draws from one `torch.Generator` on the engine's device,
  seeded with the run's seed.  Runs with it are held against the
  reference statistically.
- `ReplaySource` returns draws recorded elsewhere -- e.g. computed with
  `jax.random` on the reference's key schedule -- so that a run can be
  held against the reference bit for bit.  It raises on a missing draw,
  on a request whose kind, shape or bounds differ from the recorded
  draw, and on draws left over at the end of the run.
- `LaneSources` asks one source per lane of a sweep for each draw, in
  lane order, and stacks what they return on a leading [L] axis.  Each
  lane's source sees exactly the calls a sequential run makes (same
  streams, shapes, bounds and order, its own rate), so a lane with
  `TorchSource(seed_i)` is bit-identical to the sequential run with
  seed_i on the same device.  Draws of several lanes are never batched
  into one generator call, which would change what each lane gets.
  Each of its calls is one span ``repro_torch.sim.draw``
  (`repro_torch.utils.spans`) and counts ``draw.<stream>.calls`` (L
  generator calls) and ``draw.<stream>.values`` (the values they drew).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.spans import count, span

__all__ = ["STREAMS", "Draw", "TorchSource", "ReplaySource",
           "LaneSources"]

STREAMS = ("inj", "dst", "route")
DRAW = "repro_torch.sim.draw"


def _check_stream(stream: str) -> None:
    if stream not in STREAMS:
        raise ValueError(f"unknown random stream {stream!r} (not in {STREAMS})")


class Draw(NamedTuple):
    """One recorded draw: ``kind`` is ``"bernoulli"`` (bounds = p, value
    bool) or ``"randint"`` (bounds = (low, high), value integer)."""
    kind: str
    bounds: object
    value: np.ndarray


class TorchSource:
    """Draws from one `torch.Generator` on `device`, seeded with `seed`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def begin_cycle(self, cycle: int) -> None:
        pass

    def bernoulli(self, stream: str, p: float, shape: tuple):
        """bool tensor: True with probability p (uniform < p, as the
        reference's `jax.random.bernoulli`)."""
        _check_stream(stream)
        return torch.rand(shape, generator=self.gen,
                          device=self.device) < p

    def randint(self, stream: str, shape: tuple, low: int, high: int):
        """int32 tensor, uniform on [low, high)."""
        _check_stream(stream)
        return torch.randint(low, high, shape, generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def finish(self) -> None:
        pass


class ReplaySource:
    """Returns given draws, ``{(cycle, stream): Draw}``, as tensors on
    `device`; every one must be asked for exactly once, as recorded."""

    def __init__(self, draws: dict, device="cpu"):
        self.draws = dict(draws)
        self.device = torch.device(device)
        self.cycle = None

    def begin_cycle(self, cycle: int) -> None:
        self.cycle = int(cycle)

    def _take(self, stream: str, kind: str, bounds, shape: tuple):
        _check_stream(stream)
        key = (self.cycle, stream)
        if key not in self.draws:
            raise LookupError(f"no recorded draw for cycle {self.cycle}, "
                              f"stream {stream!r}")
        d = self.draws.pop(key)
        if (d.kind != kind or d.bounds != bounds
                or tuple(d.value.shape) != tuple(shape)):
            raise ValueError(
                f"draw at cycle {self.cycle}, stream {stream!r}: asked for "
                f"{kind} {bounds} of shape {tuple(shape)}, recorded "
                f"{d.kind} {d.bounds} of shape {tuple(d.value.shape)}")
        return d.value

    def bernoulli(self, stream: str, p: float, shape: tuple):
        v = self._take(stream, "bernoulli", p, shape)
        return torch.tensor(np.asarray(v, dtype=bool), device=self.device)

    def randint(self, stream: str, shape: tuple, low: int, high: int):
        v = self._take(stream, "randint", (low, high), shape)
        return torch.tensor(np.asarray(v, dtype=np.int32),
                            device=self.device)

    def finish(self) -> None:
        """Raise if any recorded draw was never asked for."""
        if self.draws:
            left = sorted(self.draws)[:5]
            raise ValueError(f"{len(self.draws)} recorded draws were never "
                             f"used, e.g. {left}")


class LaneSources:
    """One source per lane, asked together: every draw is each lane's own
    draw, stacked on a leading [L] axis ([1, ...] for one lane, a view).
    `bernoulli` takes one p for every lane or a sequence of L of them."""

    def __init__(self, sources):
        self.sources = list(sources)

    def begin_cycle(self, cycle: int) -> None:
        for s in self.sources:
            s.begin_cycle(cycle)

    @staticmethod
    def _stack(stream: str, draws: list):
        out = draws[0][None] if len(draws) == 1 else torch.stack(draws)
        count(f"draw.{stream}.calls", len(draws))
        count(f"draw.{stream}.values", out.numel())
        return out

    def bernoulli(self, stream: str, p, shape: tuple):
        ps = p if isinstance(p, (list, tuple)) else [p] * len(self.sources)
        with span(DRAW):
            return self._stack(stream, [
                s.bernoulli(stream, pi, shape)
                for s, pi in zip(self.sources, ps, strict=True)])

    def randint(self, stream: str, shape: tuple, low: int, high: int):
        with span(DRAW):
            return self._stack(stream, [s.randint(stream, shape, low, high)
                                        for s in self.sources])

    def finish(self) -> None:
        for s in self.sources:
            s.finish()
