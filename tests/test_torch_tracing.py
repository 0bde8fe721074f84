"""The port's counters and spans (``ursabench_tpu_torch.tracing``) on the CPU,
and the benchmark's readers of the counters: spans off record and annotate
nothing; spans on share the profiler's host clock and nest by parent and
request; the per-call counters keep the last calls and count what they
drop; a sampler's epochs, ``logits_all``'s calls, the captured launches and
the convs' layouts are counted where they happen; each reader takes the
window's calls from the counter's tail, before the traced ones."""

import statistics
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ursabench_tpu_torch
from portbench import core
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tracing
from ursabench_tpu_torch.inference import sgmcmc
from ursabench_tpu_torch.inference.ensemble import Ensemble

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


# -- spans ---------------------------------------------------------------------------


def test_span_off_records_nothing_and_never_annotates(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", request=3):
            with tracing.span("inner"):
                torch.ones(2).sum()
    assert tracing.span("a") is tracing.span("b", request=1)  # one shared object
    assert tracing.spans() == [] and tracing.spans_dropped() == 0


def test_spans_share_the_profilers_host_clock():
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with tracing.span("tracing.outer", request=i):
                with tracing.span("tracing.inner"):
                    torch.ones(64).sum()
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("tracing."):
            kineto.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    recorded = {}
    for _, _, _, name, start, end in tracing.spans():
        recorded.setdefault(name, []).append((start, end))
    assert set(recorded) == set(kineto) == {"tracing.outer", "tracing.inner"}
    for name in recorded:
        assert len(recorded[name]) == len(kineto[name]) == 20
        for (s, e), (ks, ke) in zip(sorted(recorded[name]), sorted(kineto[name])):
            assert s <= ks <= ke <= e, (name, s, ks, ke, e)
            assert ks - s < 2_000_000 and e - ke < 2_000_000


def test_span_parents_and_requests_nest_as_called():
    tracing.enable()
    with tracing.span("a", request=7):
        with tracing.span("b"):
            with tracing.span("c", request=9):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        pass
    got = {name: (sid, parent, request) for sid, parent, request, name, _, _ in tracing.spans()}
    a, b, c, d, e = (got[k] for k in "abcde")
    assert [n for *_, n, _, _ in tracing.spans()] == ["c", "b", "d", "a", "e"]  # as they end
    assert (a[1], a[2]) == (None, 7)
    assert (b[1], b[2]) == (a[0], 7) and (d[1], d[2]) == (a[0], 7)
    assert (c[1], c[2]) == (b[0], 9)
    assert (e[1], e[2]) == (None, None)
    assert len({a[0], b[0], c[0], d[0], e[0]}) == 5
    for _, _, _, _, start, end in tracing.spans():
        assert start <= end


# -- counters ------------------------------------------------------------------------


def _epoch():
    tracing.epoch_end(tracing.epoch_start(torch.device("cpu")))


@pytest.mark.parametrize("counter,attr,add,want", [
    ("sampler.epoch", "_epochs", lambda i: _epoch(), None),
    ("ensemble.logits_all", "_logits_all", lambda i: tracing.logits_all(10 * i, i),
     [(20, 2), (30, 3), (40, 4)]),
    ("program.capture", "_captures", lambda i: tracing.captured("P", float(i), 3),
     [("P", 2.0, 3), ("P", 3.0, 3), ("P", 4.0, 3)]),
])
def test_per_call_counters_drop_the_oldest_and_count_them(monkeypatch, counter, attr, add,
                                                          want):
    monkeypatch.setattr(tracing, attr, tracing.Calls(3))
    for i in range(5):
        add(i)
    c = tracing.counters()
    assert len(c[counter]) == 3 and c["dropped"][counter] == 2
    assert c[counter] == want if want is not None else all(ms >= 0.0 for ms in c[counter])


def test_bma_pass_counts_by_path():
    tracing.bma_pass(0.5, 100, "graph")
    tracing.bma_pass(0.25, 20, "eager")
    tracing.bma_pass(0.25, 100, "graph")
    assert tracing.counters()["bma.pass"] == {"seconds": 1.0, "images": 220,
                                              "passes": {"graph": 2, "eager": 1}}


def test_a_captured_launch_counts_once_a_replay(monkeypatch):
    def tracing_test_kernel():
        pass

    tracing_test_kernel.launches = 0
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    tracing.count(tracing_test_kernel)
    capturing[0] = True
    with tracing.record() as outer:
        tracing.count(tracing_test_kernel)
        with tracing.record() as inner:  # a capture inside a capture records its own
            tracing.count(tracing_test_kernel)
    capturing[0] = False
    assert outer == [tracing_test_kernel] and inner == [tracing_test_kernel]
    assert tracing_test_kernel.launches == 1
    for _ in range(4):
        tracing.replayed(outer)
    assert tracing_test_kernel.launches == 5


def test_conv_layout_counts_each_call_once_and_not_at_replays(monkeypatch):
    """``conv.layout`` counts a conv's forward when it is called: under a
    capture too, once, and a replay of the graph adds nothing; ``reset()``
    clears it."""
    module = tmodels.get_model("PreResNet8").build(10)
    convs = sum(isinstance(m, tmodels.Conv2d) for m in module.modules())
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        module.eval()(x)
        capturing = [True]
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
        with tracing.record() as captured_launches:
            module(x)
        capturing[0] = False
    for _ in range(3):
        tracing.replayed(captured_launches)
    assert tracing.counters()["conv.layout"] == {"channels_last": 0, "nchw": 2 * convs}
    tracing.reset()
    assert tracing.counters()["conv.layout"] == {"channels_last": 0, "nchw": 0}


def test_a_sampler_counts_and_spans_each_epoch():
    splits, c = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=96, synthetic_n_test=32)
    hyp = {"lr": 0.01, "prior_std": 1.0, "alpha": 0.1, "burn_in_epochs": 1, "num_samples": 2}
    s = sgmcmc.SGHMC(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                     train=splits["train"], seed=0, device="cpu")
    n = 3
    s._run_epoch()
    tracing.enable()
    for _ in range(n):
        s._run_epoch()
    ms = tracing.counters()["sampler.epoch"]
    assert len(ms) == n + 1 and all(v > 0.0 for v in ms)
    spans = tracing.spans()
    epochs = {sid: name for sid, _, _, name, _, _ in spans if name == "sampler.epoch"}
    draws = [parent for _, parent, _, name, _, _ in spans if name == "sampler.draws"]
    assert len(epochs) == n and sorted(draws) == sorted(epochs)


@pytest.mark.parametrize("strategy", ["scan", "vmap"])
def test_logits_all_counts_its_members_forwards_inside_its_time(strategy):
    module = tmodels.get_model("MLP200MNIST").build(10)
    states = []
    for k in range(3):
        torch.manual_seed(k)
        states.append({n: v + 0.01 * torch.randn_like(v) for n, v in module.state_dict().items()})
    ens = Ensemble.from_list(module, states)
    ens.member_strategy = strategy
    x = torch.rand(4, 1, 28, 28)
    tracing.enable()
    for bi in range(2):
        ens.logits_all(x, bi)
    calls = tracing.counters()["ensemble.logits_all"]
    assert len(calls) == 2 and all(0 < m <= t for t, m in calls)
    names = [name for *_, name, _, _ in tracing.spans()]
    forwards = 2 * (3 if strategy == "scan" else 1)
    assert names.count("ensemble.logits_all") == 2
    assert names.count("ensemble.member_forward") == forwards
    assert names.count("ensemble.member_state") == (forwards if strategy == "scan" else 0)
    assert names.count("ensemble.stack") == (2 if strategy == "scan" else 0)


# -- the benchmark's readers ---------------------------------------------------------


def _run(window: dict, traced: bool):
    cell = types.SimpleNamespace(traffic={"traced_requests": 2})
    return core.Run(cell, 1.0, window, {}, object() if traced else None)


# three epochs of set-up and earlier windows, the window's four, one traced
EPOCHS = [900.0, 950.0, 1000.0, 1100.0, 1000.0, 1000.0, 1010.0, 5000.0]
WINDOW = EPOCHS[3:7]
# one warm-up call, the window's three, two traced
CALLS = [(9e6, 1e6), (40e6, 30e6), (42e6, 31e6), (45e6, 36e6), (1e9, 2e8), (1e9, 2e8)]
CAPTURES = [("_EpochProgram", 120.0, 3), ("_PassProgram", 30.5, 3)]
SAMPLER = {"epochs": 4}
REQUESTS = {"requests": 3}
SAMPLER_METRICS = [
    ("epoch_device_ms", statistics.median(WINDOW)),
    ("epoch_device_ms.short_kernels", statistics.median(WINDOW)),
    ("epoch_excess_pct", 100 * (statistics.fmean(WINDOW) / statistics.median(WINDOW[2:]) - 1)),
    ("epoch_excess_pct.short_kernels",
     100 * (statistics.fmean(WINDOW) / statistics.median(WINDOW[2:]) - 1)),
    ("capture_ms", 150.5),
]
REQUEST_METRICS = [("members_enqueue_ms", 31.0), ("logits_all_rest_ms", 10.0)]


@pytest.fixture
def fake_counters(monkeypatch):
    monkeypatch.setattr(tracing, "counters", lambda: {
        "sampler.epoch": list(EPOCHS), "ensemble.logits_all": list(CALLS),
        "program.capture": list(CAPTURES)})


@pytest.mark.parametrize("metric,want", SAMPLER_METRICS + REQUEST_METRICS)
def test_each_reader_takes_the_window_before_the_traced_calls(fake_counters, metric, want):
    read = core.Registry().module("metrics", metric).read
    window = SAMPLER if (metric, want) in SAMPLER_METRICS else REQUESTS
    assert read(_run(window, traced=True)) == pytest.approx(want)
    other = REQUESTS if window is SAMPLER else SAMPLER
    assert read(_run(other, traced=True)) is None  # another kind of cell reads nothing


@pytest.mark.parametrize("metric", [m for m, _ in SAMPLER_METRICS + REQUEST_METRICS])
def test_each_reader_reads_nothing_from_a_program_without_counters(monkeypatch, metric):
    read = core.Registry().module("metrics", metric).read
    # the import of the program's tracing fails, as in a program without it
    monkeypatch.delattr(ursabench_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "ursabench_tpu_torch.tracing", None)
    for window in (SAMPLER, REQUESTS):
        assert read(_run(window, traced=True)) is None


def test_readers_of_an_untraced_window_take_the_counters_tail(fake_counters):
    reg = core.Registry()
    assert reg.module("metrics", "epoch_device_ms").read(_run(SAMPLER, traced=False)) == (
        statistics.median(EPOCHS[4:]))
    assert reg.module("metrics", "members_enqueue_ms").read(
        _run(REQUESTS, traced=False)) == pytest.approx(200.0)
    too_long = {"epochs": len(EPOCHS)}  # more epochs than the counter holds: nothing
    assert reg.module("metrics", "epoch_device_ms").read(_run(too_long, traced=True)) is None
