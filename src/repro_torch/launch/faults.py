"""Fault-tolerance harness: heartbeat, straggler detection, preemption,
a copy of `repro.launch.faults` (plain Python, no jax).

  - heartbeat(step): stamps progress; a step taking longer than
    `straggler_factor` x the EMA step time flags a straggler.
  - preemption: SIGTERM flips a flag; the train loop checkpoints and
    exits cleanly at the next step boundary (checkpoint/restart).
  - simulated faults for tests: inject_preemption().
"""

from __future__ import annotations

import signal
import threading
import time
from typing import List, Optional

__all__ = ["FaultMonitor"]


class FaultMonitor:
    def __init__(self, straggler_factor: float = 3.0, ema: float = 0.9,
                 install_signal_handler: bool = False):
        self.straggler_factor = straggler_factor
        self.ema_coef = ema
        self.ema_dt: Optional[float] = None
        self.last_t: Optional[float] = None
        self.straggler_events: List[dict] = []
        self._preempted = threading.Event()
        if install_signal_handler:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    # ---- heartbeat / straggler ------------------------------------------
    def heartbeat(self, step: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        if self.last_t is not None:
            dt = now - self.last_t
            if self.ema_dt is None:
                self.ema_dt = dt
            else:
                if dt > self.straggler_factor * self.ema_dt:
                    self.straggler_events.append(
                        dict(step=step, dt=dt, ema=self.ema_dt))
                self.ema_dt = (self.ema_coef * self.ema_dt
                               + (1 - self.ema_coef) * dt)
        self.last_t = now

    @property
    def is_straggling(self) -> bool:
        return bool(self.straggler_events)

    # ---- preemption -------------------------------------------------------
    def _on_sigterm(self, *_):
        self._preempted.set()

    def inject_preemption(self):
        self._preempted.set()

    def should_checkpoint_and_exit(self) -> bool:
        return self._preempted.is_set()
