from .init import fan_out_normal_, torch_linear_

__all__ = ["fan_out_normal_", "torch_linear_"]
