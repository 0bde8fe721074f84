from .base import _Task, accumulate_split
from .decision import Decision
from .distilled import DistilledPair, OODDetectionDistilled, PredictionDistilled
from .ood_detection import OODDetection
from .prediction import Prediction

__all__ = [
    "_Task", "Prediction", "OODDetection", "Decision",
    "PredictionDistilled", "OODDetectionDistilled", "DistilledPair", "accumulate_split",
]


def get_task(name: str):
    import sys

    mod = sys.modules[__name__]
    if not hasattr(mod, name):
        raise KeyError(f"Unknown task '{name}'")
    return getattr(mod, name)
