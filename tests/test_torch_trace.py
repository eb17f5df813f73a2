"""The port's checked profiler traces (crdmodel_tpu_torch/ops/trace.py) on
made-up chrome-trace events: own_kernels keeps the kernels of the launches
after the primers and counts the launches that lost theirs, and traced
takes a trace again, with more primers, until one holds every kernel.
"""

import contextlib

import pytest

from crdmodel_tpu_torch.ops import trace


def launch(corr, name="cudaLaunchKernel"):
    return {"cat": "cuda_runtime", "name": name, "ts": corr,
            "args": {"correlation": corr}}


def kernel(corr, name="k"):
    return {"cat": "kernel", "name": name, "ts": corr, "dur": 1.0,
            "args": {"correlation": corr}}


def events(prime, own, kept, other=()):
    """A trace of `prime` primer launches and `own` launches after them
    (correlation ids 1, 2, ...), the kernels of the ids in `kept`, and the
    host events `other`."""
    ids = range(1, prime + own + 1)
    return ([launch(c) for c in ids] + [kernel(c, f"k{c}") for c in kept]
            + list(other))


@pytest.mark.parametrize("prime, own, kept, names, lost", [
    # whole: the primers' kernels are not the body's
    (3, 2, [1, 2, 3, 4, 5], ["k4", "k5"], 0),
    # the primers lost their kernels, the body kept its own
    (3, 2, [5, 4], ["k5", "k4"], 0),
    # the body's first launch lost its kernel
    (3, 2, [1, 2, 3, 5], ["k5"], 1),
    # every kernel lost
    (3, 2, [], [], 2),
    # no primers
    (0, 2, [1, 2], ["k1", "k2"], 0),
])
def test_own_kernels(prime, own, kept, names, lost):
    got, n_lost = trace.own_kernels(events(prime, own, kept), prime)
    assert [e["name"] for e in got] == names
    assert n_lost == lost


def test_own_kernels_counts_every_launch_call_and_only_those():
    other = [launch(10, "cuLaunchKernel"), kernel(10, "driver"),
             launch(11, "cudaLaunchKernelExC"),
             {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
              "ts": 12, "args": {"correlation": 12}},
             {"cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 13,
              "args": {"correlation": 13}},
             {"cat": "Trace", "name": "PyTorch Profiler", "ts": 0}]
    got, lost = trace.own_kernels(events(1, 1, [1, 2], other), 1)
    assert [e["name"] for e in got] == ["k2", "driver"]
    assert lost == 1        # cudaLaunchKernelExC's kernel is missing


def test_own_kernels_fewer_launches_than_primers():
    assert trace.own_kernels(events(2, 0, [1, 2]), 3) == ([], 1)


class FakeWindows:
    """Stands in for the profiler: the n-th trace holds the events of
    outcomes[n] for the primers it was opened with."""

    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.primes = []

    @contextlib.contextmanager
    def window(self, cpu, prime):
        self.primes.append(prime)
        yield prime

    def events(self, prime):
        whole = self.outcomes.pop(0)
        return events(prime, 2, range(1, prime + 3) if whole
                      else range(1, prime + 2))


def test_traced_takes_a_trace_again_until_it_is_whole(monkeypatch):
    fake = FakeWindows([False, False, True])
    monkeypatch.setattr(trace, "_window", fake.window)
    monkeypatch.setattr(trace, "_events", fake.events)
    monkeypatch.setattr(trace.traced, "taken", 0)
    monkeypatch.setattr(trace.traced, "retaken", 0)
    calls = []
    kernels, result = trace.traced(lambda: calls.append(1) or "done")
    assert result == "done" and len(calls) == 3
    assert (trace.traced.taken, trace.traced.retaken) == (3, 2)
    assert fake.primes == [trace.PRIME, trace.PRIME * trace.PRIME_GROWTH,
                           trace.PRIME * trace.PRIME_GROWTH ** 2]
    p = fake.primes[-1]
    assert [e["name"] for e in kernels] == [f"k{p + 1}", f"k{p + 2}"]


def test_traced_raises_when_no_trace_is_whole(monkeypatch):
    fake = FakeWindows([False] * trace.ATTEMPTS)
    monkeypatch.setattr(trace, "_window", fake.window)
    monkeypatch.setattr(trace, "_events", fake.events)
    with pytest.raises(AssertionError, match="lost the kernels"):
        trace.traced(lambda: None)
    assert len(fake.primes) == trace.ATTEMPTS


def test_kernel_names_reads_the_whole_trace(monkeypatch):
    fake = FakeWindows([True])
    monkeypatch.setattr(trace, "_window", fake.window)
    monkeypatch.setattr(trace, "_events", fake.events)
    p = trace.PRIME
    assert trace.kernel_names(lambda: None, n=2) == [f"k{p + 1}",
                                                     f"k{p + 2}"]


def test_kernel_names_raises_when_nothing_was_launched(monkeypatch):
    monkeypatch.setattr(trace, "_window", FakeWindows([]).window)
    monkeypatch.setattr(trace, "_events",
                        lambda prime: events(prime, 0, range(1, prime + 1)))
    with pytest.raises(AssertionError, match="launched no kernel"):
        trace.kernel_names(lambda: None)
