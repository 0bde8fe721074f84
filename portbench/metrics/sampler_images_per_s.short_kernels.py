"""``sampler_images_per_s.short_kernels``: ``sampler_images_per_s`` in the
cells whose step is hundreds of short kernels (PreResNet-20 in fp32). Their
rate swings with a slow phase of the card at the window's start, of
unknown cause and length, and takes a wider bound than a step of long
kernels: it has a name of its own, and its per-layer metrics too."""

from portbench.metrics.sampler_images_per_s import read  # noqa: F401
