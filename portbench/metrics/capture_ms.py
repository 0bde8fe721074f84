"""``capture_ms``: the host milliseconds of every capture of a CUDA graph in
the run, summed, from the program's ``program.capture`` counter
((program, ms, warm-up steps) a capture); a sampler captures its step once,
in its first epoch, which set-up runs."""

from portbench.counters import program_counters


def read(run):
    counters = program_counters()
    if counters is None or "epochs" not in run.window or not counters["program.capture"]:
        return None
    return sum(ms for _, ms, _ in counters["program.capture"])
