"""``k1_roofline.short_kernels``: ``k1_roofline`` in the cells that report
``sampler_images_per_s.short_kernels``."""

from portbench.metrics.k1_roofline import read  # noqa: F401
