"""K1 at one row against another version of its source, bit for bit.

Builds ``--before``, a ``sghmc_update.cu`` with the single-row C interface
``sghmc_update_f32(p, v, g, scalars, n, seed, stream)``, beside the current
K1, runs both on the same buffers, float32[5] scalars and seeds with the
noise on, from 1,000 to 73 M floats and at a start 8 bytes off a 16-byte
boundary, and exits non-zero unless every output is bit-equal. Needs a GPU:

    git show <commit>:ursabench_tpu_torch/csrc/sghmc_update.cu > _archive/k1_before.cu
    python -m ursabench_tpu_torch.profiling.k1_regression --before _archive/k1_before.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..kernels import build
from ..kernels.sghmc import sghmc_update_flat
from ..ops.sgmcmc import sghmc_scalars
from .hw import card_line

# PreResNet-20, 4 sweep rows of it, and two stacked WideResNet-28x10 chains
SIZES = (1000, 8193, 272282, 1089128, 73073768)
OFFSETS = {272282: (0, 2)}  # a start 2 floats in: the scalar path


def _before(source: Path):
    fn = build.load(source.resolve()).lib.sghmc_update_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_ulonglong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def compare(source: Path, device) -> list:
    """One row a case: size, offset, is_first, and whether p and v agree."""
    before = _before(source)
    gen = torch.Generator(device=device).manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    cases = []
    for n in SIZES:
        for off in OFFSETS.get(n, (0,)):
            p0, v0, g0 = (torch.randn(n + off, generator=gen, device=device) for _ in range(3))
            g = g0[off:]
            for first in (False, True):
                s = sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1.0 / 50000,
                                  n_train=50000.0, noise_on=1.0, is_first_step=first,
                                  device=device)
                seed = n + off + first
                new = [t.clone()[off:] for t in (p0, v0)]
                sghmc_update_flat(*new, g, s, seed=seed)
                old = [t.clone()[off:] for t in (p0, v0)]
                err = before(old[0].data_ptr(), old[1].data_ptr(), g.data_ptr(), s.data_ptr(),
                             n, seed, stream)
                if err != 0:
                    raise RuntimeError(f"the earlier K1 failed to launch: CUDA error {err}")
                torch.cuda.synchronize(device)
                cases.append({"n": n, "offset": off, "first": first,
                              "equal": all(torch.equal(a, b) for a, b in zip(new, old))})
    return cases


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", flush=True)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", type=Path, required=True,
                    help="the earlier sghmc_update.cu, with the single-row C interface")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    cases = compare(args.before, torch.device("cuda"))
    print(json.dumps({"k1_regression": cases}), flush=True)
    equal = sum(c["equal"] for c in cases)
    print(f"K1 against {args.before}: {equal} of {len(cases)} noise-on launches bit-equal",
          flush=True)
    return 0 if equal == len(cases) else 1


if __name__ == "__main__":
    sys.exit(main())
