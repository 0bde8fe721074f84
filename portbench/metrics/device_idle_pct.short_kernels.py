"""``device_idle_pct.short_kernels``: ``device_idle_pct.sampler`` (100 less the
union of the card's activities over one traced epoch) in the cells that
report ``sampler_images_per_s.short_kernels``."""

from portbench.trace import idle_pct


def read(run):
    if run.trace is None or "epochs" not in run.window:
        return None
    return idle_pct(run.trace)
