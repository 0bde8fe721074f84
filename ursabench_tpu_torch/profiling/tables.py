"""LaTeX latency tables: the trtprof ``make_table.py`` pivot (precision
columns by model x dataset x S x batch rows), as in
``ursabench_tpu/profiling/tables.py``, for the cache of ``latency.run_sweep``."""

from __future__ import annotations

from collections import defaultdict

_CAPTION = (
    "% per-call: the eager forward plus the device->host copy of its result,\n"
    "%   timed on the host clock per call (trtprof prof.py:153-171 protocol:\n"
    "%   30 warm-up calls, 10 calls per batch, 10-batch burn-in).\n"
    "% device: one forward captured in a CUDA graph, replayed K times between\n"
    "%   two CUDA events, /K: the device's time without host dispatch.\n"
    "% %peak = achieved FLOP/s over the device's bf16 dense peak for every\n"
    "%   precision (fp32 and int8 rows are percent of the bf16 number).\n"
)


def _fmt_ms(mean_s, std_s):
    if std_s is None:
        return f"${mean_s * 1e3:.3f}$"
    return f"${mean_s * 1e3:.3f} \\pm {std_s * 1e3:.3f}$"


def make_latex_table(cache: dict) -> str:
    """cache: key -> result dict from ``profiling.latency.run_sweep``.
    Renders a per-call latency column per precision (when measured) and,
    when the device engine was timed, a device latency and a percent-of-peak
    column per precision."""
    rows = defaultdict(dict)
    precisions = set()
    has_call = has_amort = False
    for r in cache.values():
        rows[(r["model"], r["dataset"], r["ensemble_size"], r["batch_size"])][
            r["precision"]] = r
        precisions.add(r["precision"])
        has_call |= "latency_mean_s" in r
        has_amort |= "amortized_latency_s" in r
    precs = sorted(precisions)
    cols, heads = [], []
    if has_call:
        cols.append("call")
        heads += [f"{p} call (ms)" for p in precs]
    if has_amort:
        cols += ["dev", "mfu"]
        heads += [f"{p} device (ms)" for p in precs]
        heads += [f"{p} \\%peak" for p in precs]
    header = (
        _CAPTION
        + "\\begin{tabular}{llrr" + "r" * len(precs) * len(cols)
        + "}\n\\toprule\nmodel & dataset & S & batch & "
        + " & ".join(heads) + " \\\\\n\\midrule\n"
    )
    body = []
    for (model, dataset, s, b), by_prec in sorted(rows.items()):
        cells = []
        for kind in cols:
            for p in precs:
                r = by_prec.get(p)
                if r is None:
                    cells.append("--")
                elif kind == "call" and "latency_mean_s" in r:
                    cells.append(_fmt_ms(r["latency_mean_s"], r.get("latency_std_s")))
                elif kind == "dev" and "amortized_latency_s" in r:
                    cells.append(_fmt_ms(r["amortized_latency_s"],
                                         r.get("amortized_latency_std_s")))
                elif kind == "mfu" and r.get("mfu_pct_of_bf16_peak") is not None:
                    cells.append(f'{r["mfu_pct_of_bf16_peak"]:.1f}')
                else:
                    cells.append("--")
        body.append(f"{model} & {dataset} & {s} & {b} & " + " & ".join(cells) + " \\\\")
    return header + "\n".join(body) + "\n\\bottomrule\n\\end{tabular}"
