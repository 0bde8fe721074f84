from .base import accumulate_split
from .prediction import Prediction

__all__ = ["Prediction", "accumulate_split"]
