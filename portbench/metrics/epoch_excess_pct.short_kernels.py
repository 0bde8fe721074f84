"""``epoch_excess_pct.short_kernels``: ``epoch_excess_pct`` in the cells that
report ``sampler_images_per_s.short_kernels``, where PreResNet-20's slow
phase shows."""

from portbench.metrics.epoch_excess_pct import read  # noqa: F401
