"""``bma_mfu_pct``: the ensemble forward's share of the card's peak in the
configuration's precision: one image's forward FLOPs (the benchmark's
reference model, ``flops.forward_flops``) x members x images scored in the
window, over the window's seconds and the peak."""

from portbench.flops import forward_flops


def read(run):
    w = run.window
    if "members" not in w:
        return None
    flops = forward_flops(run.cell.model(), 1) * w["forward_images"]
    return 100.0 * flops / w["seconds"] / run.peaks[run.cell.config["precision"]]
