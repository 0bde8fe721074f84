"""``step_mfu_pct.short_kernels``: ``step_mfu_pct`` in the cells that report
``sampler_images_per_s.short_kernels``."""

from portbench.metrics.step_mfu_pct import read  # noqa: F401
