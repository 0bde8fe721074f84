"""Unified CLI: ``python -m ursabench_tpu_torch.cli <command> ...``

Commands (counterpart of ``ursabench_tpu/cli.py``):
  run        — the benchmark runner (experiment.py)
  hypopt     — sequential BayesOpt (run_hypopt.py main_seq)
  hypopt-par — RandomSearch, one runner process per configuration
               (run_hypopt.py main_par; --dry_run prints the commands)
  profile    — ensemble latency profiling (profiling/latency.py)
  models     — list the registered models
  time       — per-method sampler wall time (time_script.py)

Over several cards, one process a card: ``torchrun --nproc_per_node N -m
ursabench_tpu_torch.cli run ... --mesh auto`` (``experiment.py``).
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        from .experiment import main as run_main

        run_main(rest)
    elif cmd == "hypopt":
        from .run_hypopt import main_seq

        main_seq(rest)
    elif cmd == "hypopt-par":
        from .run_hypopt import main_par

        main_par(rest)
    elif cmd == "profile":
        from .profiling.latency import main as prof_main

        prof_main(rest)
    elif cmd == "models":
        from . import models

        for name in models.list_models():
            print(name)
    elif cmd == "time":
        from .time_script import main as time_main

        time_main(rest)
    else:
        print(f"Unknown command {cmd!r}.\n{__doc__}")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
