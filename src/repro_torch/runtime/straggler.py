"""Straggler detection/mitigation: EWMA step-time model with outlier ranks
(a copy of ``repro/runtime/straggler.py``, which is pure numpy).

At 1000+-node scale the slowest rank gates every synchronous collective.
The monitor keeps a per-rank EWMA of step times; ranks slower than
``threshold × median`` are flagged, and the mitigation hook (re-balance
batch shards away from the rank, or evict → elastic re-mesh) fires after
``patience`` consecutive flags.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class _RankState:
    ewma: Optional[float] = None
    flags: int = 0


class StragglerMonitor:
    def __init__(self, n_ranks: int, alpha: float = 0.2,
                 threshold: float = 1.5, patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ranks: List[_RankState] = [_RankState() for _ in range(n_ranks)]
        self.mitigations: List[Dict] = []

    def observe(self, step: int, step_times: np.ndarray,
                mitigate: Optional[Callable[[int], None]] = None
                ) -> List[int]:
        """Record one step's per-rank times; returns ranks mitigated."""
        for r, t in enumerate(step_times):
            st = self.ranks[r]
            st.ewma = t if st.ewma is None else (
                self.alpha * t + (1 - self.alpha) * st.ewma
            )
        med = float(np.median([s.ewma for s in self.ranks]))
        fired = []
        for r, st in enumerate(self.ranks):
            if st.ewma > self.threshold * med:
                st.flags += 1
                if st.flags >= self.patience:
                    fired.append(r)
                    st.flags = 0
                    self.mitigations.append(
                        {"step": step, "rank": r, "ewma": st.ewma,
                         "median": med}
                    )
                    if mitigate is not None:
                        mitigate(r)
            else:
                st.flags = 0
        return fired
