from . import hw, quantize
from .latency import (ProfileConfig, build_amortized_engine, build_engine,
                      profile_config, profile_prediction, run_sweep,
                      time_amortized, time_engine)
from .quantize import dequantize_state, quantization_error, quantize_state
from .tables import make_latex_table

__all__ = [
    "ProfileConfig", "build_amortized_engine", "build_engine", "profile_config",
    "profile_prediction", "run_sweep", "time_amortized", "time_engine",
    "make_latex_table", "quantize_state", "dequantize_state",
    "quantization_error", "hw", "quantize",
]
