"""Action-chunk ensembling (port of ``pointcloudmatters_tpu/utils/misc.py``):
``TemporalAgg``, numpy on the host. Its buffer is float64, as in JAX."""

from __future__ import annotations

import numpy as np

__all__ = ["TemporalAgg"]


class TemporalAgg:
    """Exponential action-chunk ensembling (reference `misc.py:88-140`).

    Keeps a rolling buffer of the last ``chunk_size`` predicted chunks; the
    action executed at time t is the exp-weighted average (weight
    ``exp(-k*age)``) of every chunk's prediction for t.
    """

    def __init__(self, apply: bool = False, action_dim: int = 8,
                 chunk_size: int = 20, k: float = 0.01):
        self.apply = apply
        if self.apply:
            self.action_dim = action_dim
            self.chunk_size = chunk_size
            self.k = k
            self.full_action = False
            self.action_buffer = np.zeros((chunk_size, chunk_size, action_dim))

    def reset(self) -> None:
        self.action_buffer = np.zeros(
            (self.chunk_size, self.chunk_size, self.action_dim)
        )
        self.full_action = False

    def _populated(self) -> int:
        if self.full_action:
            return self.chunk_size
        return int(((self.action_buffer != 0).sum(1).sum(1) != 0).sum())

    def add_action(self, action: np.ndarray) -> None:
        if not self.full_action:
            t = self._populated()
            self.action_buffer[t] = action
            if t == self.chunk_size - 1:
                self.full_action = True
        else:
            self.action_buffer = np.roll(self.action_buffer, -1, axis=0)
            self.action_buffer[-1] = action

    def get_action(self) -> np.ndarray:
        n = self._populated()
        exp_weights = np.exp(-np.arange(n) * self.k)
        exp_weights = exp_weights / exp_weights.sum()
        # chunk added i steps ago predicts the current action at index i
        # (anti-diagonal selection, same as the reference's flipped-eye mask)
        current = self.action_buffer[:n][
            np.eye(self.chunk_size)[::-1][-n:].astype(bool)
        ]
        return (current * exp_weights[:, None]).sum(0)

    def __call__(self, action_chunk: np.ndarray) -> np.ndarray:
        """action_chunk: (num_queries, action_dim) for one env."""
        if not self.apply:
            return action_chunk[0]
        self.add_action(action_chunk)
        return self.get_action()
