"""Optimizer utilities (counterpart of heat_tpu/optim/utils.py; reference:
heat/optim/utils.py).

``DetectMetricPlateau`` is a faithful re-implementation of the reference's
loss-stability controller (utils.py:14-206): it watches a metric over a
patience window and reports when it has stopped improving.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detect if a metric plateaus (reference optim/utils.py:14-71).

    Parameters
    ----------
    mode : 'min' or 'max'
        Whether lower or higher metric values are better.
    patience : int
        Epochs with no improvement before declaring a plateau.
    threshold : float
        Minimum relative/absolute change counting as improvement.
    threshold_mode : 'rel' or 'abs'
    """

    def __init__(
        self,
        mode: str = "min",
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown!")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown!")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.num_bad_epochs: int = 0
        self.mode_worse: Optional[float] = float("inf") if mode == "min" else -float("inf")
        self.best = self.mode_worse
        self.last_epoch = 0

    def get_state(self) -> Dict:
        """Serializable state dict (reference utils.py:72-89)."""
        return {
            "mode": self.mode,
            "patience": self.patience,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "num_bad_epochs": self.num_bad_epochs,
            "mode_worse": self.mode_worse,
            "best": self.best,
            "last_epoch": self.last_epoch,
        }

    def set_state(self, dic: Dict) -> None:
        """Restore from a state dict (reference utils.py:90-108)."""
        for key, value in dic.items():
            setattr(self, key, value)

    def reset(self) -> None:
        """Reset the tracker (reference utils.py:109-120)."""
        self.num_bad_epochs = 0
        self.best = self.mode_worse

    def test_if_improving(self, metric: float) -> bool:
        """True if the metric has plateaued (reference utils.py:121-160)."""
        current = float(metric)
        self.last_epoch += 1
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return True
        return False

    def is_better(self, a: float, best: float) -> bool:
        """Comparison under the configured mode (reference utils.py:161-206)."""
        if self.mode == "min" and self.threshold_mode == "rel":
            rel_epsilon = 1.0 - self.threshold
            return a < best * rel_epsilon
        if self.mode == "min" and self.threshold_mode == "abs":
            return a < best - self.threshold
        if self.mode == "max" and self.threshold_mode == "rel":
            rel_epsilon = self.threshold + 1.0
            return a > best * rel_epsilon
        return a > best + self.threshold
