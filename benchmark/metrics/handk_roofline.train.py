"""The hand-written kernels' sites against their roofline, %: the least
time their work takes at the card's published bandwidth, over the device
time of the kernels that ran them (BlurPool and DropBlock, by name). The
work is counted from the sites' shapes (``benchmark/work.py``): each input
read once, each output written once, a step's forward and backward."""

from benchmark.trace import category
from benchmark.work import handk_step_bytes


def read(run):
    w = run.window
    if not (w and w.units and run.peaks):
        return None
    spent = sum(e - s for n, s, e in w.device if category(n) == "hand-written kernels") / 1e6
    work = handk_step_bytes(run.config["model"], run.config["image_size"],
                            run.traffic["per_card_batch"]) * w.units
    if spent <= 0 or work <= 0:
        return None
    return 100.0 * work / run.peaks["hbm_byte_s"] / spent
