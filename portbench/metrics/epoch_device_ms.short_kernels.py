"""``epoch_device_ms.short_kernels``: ``epoch_device_ms`` in the cells that
report ``sampler_images_per_s.short_kernels``."""

from portbench.metrics.epoch_device_ms import read  # noqa: F401
