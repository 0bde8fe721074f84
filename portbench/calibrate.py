"""The readings a cell's limits are set from, on the card at the cell's own
sizes, several seeds in one process (no measured window):

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed, one JSON line: the checked numbers of the program (sound
runs: the lower readings), of the control (the reference computed in the
precision below the configuration's, the configuration's ``control``, put
in the program's place) and, for a sampler, of the reference with half of
each batch left out (a fault), each against the reference. A limit lies
above the largest program reading and below the smallest of the control's
and of the faults' that read ten times the program's or more.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import core


def readings(name: str, seeds, registry: core.Registry = None, device=None):
    registry = registry or core.Registry()
    device = torch.device(device or "cuda")
    for seed in seeds:
        cell = core.Cell.load(registry, name, seed, device)
        tf32 = bool(cell.config.get("allow_tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        driver = cell.driver()
        driver.setup([])
        out = driver.calibrate(cell.config["control"])
        del driver
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield {"workload": name, "seed": seed, **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    for line in readings(args.workload, args.seeds):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
