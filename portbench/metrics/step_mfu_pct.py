"""``step_mfu_pct``: the whole sampler step's share of the card's peak in the
configuration's precision: one step's FLOPs (counted from the shapes of the
benchmark's reference model, ``flops.train_step_flops``) x chains x steps
in the window, over the window's seconds and the peak."""

from portbench.flops import train_step_flops


def read(run):
    w = run.window
    if "epochs" not in w:
        return None
    flops = train_step_flops(run.cell.model(), w["batch"]) * w["chains"] * w["steps"]
    return 100.0 * flops / w["seconds"] / run.peaks[run.cell.config["precision"]]
