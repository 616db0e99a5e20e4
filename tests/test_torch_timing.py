"""The profiler summary of ``benchmarks/kernel_timing.py``, on fake events,
and its bounds.

``device_ms`` times a call from ``torch.profiler``'s ``key_averages()``,
which sometimes drops events. ``summarise_events`` turns those averages into
a time per call; given the launches a call makes, it refuses a capture that
holds fewer than half of them. These run on the CPU with stand-ins for the
profiler's averages.
"""

from types import SimpleNamespace

import pytest

from bark_tpu_torch.benchmarks.kernel_timing import k1_bound, summarise_events

CALLS = 20


def event(key, count, us, device="DeviceType.CUDA", field="device_time_total"):
    return SimpleNamespace(key=key, count=count, device_type=device, **{field: us})


def k1_events(planes: int, grams: int):
    """A K1 capture: ``planes`` plane-pass events of 2 us, ``grams`` Gram
    events of 10 us, and host-side events that must be ignored."""
    return [
        event("void gram_planes_kernel<6>(Leaves, int, int, int, int, unsigned int*, float*)",
              planes, 2.0 * planes),
        event("void gram_kernel<6, 64, 4>(unsigned int const*, ...)", grams, 10.0 * grams),
        event("aten::empty", 4 * CALLS, 99.0, device="DeviceType.CPU"),
        event("cudaLaunchKernel", 3 * CALLS, 50.0, device="DeviceType.CPU"),
    ]


@pytest.mark.parametrize(
    "planes, grams, ms",
    [
        (2 * CALLS, CALLS, 0.014),  # a full capture: two plane passes and a Gram a call
        (2 * CALLS - 6, CALLS - 4, 0.014),  # 15% lost: the mean duration times 2 and 1
    ],
    ids=["full", "partial"],
)
def test_summary_times_a_capture_that_holds_enough(planes, grams, ms):
    total, per_call, split = summarise_events(k1_events(planes, grams), CALLS, "gram", 3)
    assert per_call == 3
    assert total == pytest.approx(ms)
    assert len(split) == 2 and sum(split.values()) == pytest.approx(ms)


@pytest.mark.parametrize("planes, grams", [(12, 6), (0, 0)], ids=["under-half", "none"])
def test_summary_refuses_a_capture_under_half_the_launches(planes, grams):
    """18 (or 0) of the 60 kernels that 20 calls launch: too few to time."""
    with pytest.raises(RuntimeError, match="captured"):
        summarise_events(k1_events(planes, grams), CALLS, "gram", 3)


def test_summary_without_an_expected_count():
    """No count given: an empty capture is (None, 0, {}), a partial one is
    timed from what it holds; ``match`` None takes every device kernel and
    older torch's ``cuda_time_total`` is read too."""
    assert summarise_events(k1_events(0, 0), CALLS, "gram") == (None, 0, {})
    total, per_call, _ = summarise_events(k1_events(12, 6), CALLS, "gram")
    assert per_call == 2 and total == pytest.approx(0.012)
    old = [event("chol_inv_kernel(float const*, float*, float*, int)", CALLS, 100.0 * CALLS,
                 field="cuda_time_total"),
           event("void at::native::copy_kernel", CALLS, 5.0 * CALLS)]
    total, per_call, split = summarise_events(old, CALLS, None, 2)
    assert per_call == 2 and total == pytest.approx(0.105)
    total, per_call, _ = summarise_events(old, CALLS, "chol_inv_kernel", 1)
    assert per_call == 1 and total == pytest.approx(0.1)


@pytest.mark.parametrize("short, ok", [(1, True), (3, False)], ids=["retaken", "refused"])
def test_device_ms_takes_a_short_capture_again(monkeypatch, short, ok):
    """``device_ms`` with a stand-in profiler whose first ``short`` captures
    hold nothing: a later full capture is timed, three short ones raise."""
    import torch
    import torch.profiler

    from bark_tpu_torch.benchmarks import kernel_timing

    captures = iter([k1_events(0, 0)] * short + [k1_events(2 * CALLS, CALLS)])

    class FakeProfile:
        def __init__(self, **_):
            self.events = next(captures)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = []
    run = lambda: calls.append(1)  # noqa: E731
    if ok:
        total, per_call, _ = kernel_timing.device_ms(torch, run, "gram", CALLS, launches=3)
        assert per_call == 3 and total == pytest.approx(0.014)
        assert len(calls) == 2 * (3 + CALLS)
    else:
        with pytest.raises(RuntimeError, match="in each of 3 captures"):
            kernel_timing.device_ms(torch, run, "gram", CALLS, launches=3)


@pytest.mark.parametrize(
    "captures, launches, source",
    [
        ([k1_events(2 * CALLS, CALLS)], 3, "profiler"),
        ([k1_events(0, 0)] * 3, 3, "events"),  # every capture short: refused, then events
        ([k1_events(0, 0)], None, "events"),  # no count expected and nothing captured
    ],
    ids=["profiler", "short", "empty"],
)
def test_kernel_time_falls_back_to_events(monkeypatch, captures, launches, source):
    """``kernel_time`` takes the profiler's time where a capture holds the
    kernels, and CUDA events (``event_ms``) where none does."""
    import torch
    import torch.profiler

    from bark_tpu_torch.benchmarks import kernel_timing

    it = iter(captures)

    class FakeProfile:
        def __init__(self, **_):
            self.events = next(it)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(kernel_timing, "event_ms", lambda torch, fn: 0.5)
    ms, per_call, split, got = kernel_timing.kernel_time(torch, lambda: None, "gram", launches)
    assert got == source
    if source == "profiler":
        assert (ms, per_call, len(split)) == (pytest.approx(0.014), 3, 2)
    else:
        assert (ms, per_call, split) == (0.5, launches, {})


def test_event_ms_times_calls_queued_behind_a_spin():
    """``event_ms`` spins the device before its start event, then times
    ``calls`` calls between two events: the median of ``reps`` over calls."""
    from bark_tpu_torch.benchmarks import kernel_timing

    log = []

    class Event:
        clock = iter([0.0, 8.0, 10.0, 14.0, 20.0, 30.0])

        def __init__(self, **_):
            self.t = None

        def record(self):
            self.t = next(Event.clock)
            log.append("record")

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    cuda = SimpleNamespace(
        Event=Event, synchronize=lambda: None, current_device=lambda: 0,
        get_device_properties=lambda d: SimpleNamespace(clock_rate=1_000_000),
        _sleep=lambda cycles: log.append(("spin", cycles)),
    )
    fake = SimpleNamespace(cuda=cuda)
    calls = []
    ms = kernel_timing.event_ms(fake, lambda: calls.append(1), calls=4, reps=3)
    assert len(calls) == 3 + 4 + 3 * 4
    spins = [e for e in log if e != "record"]
    assert len(spins) == 3 and all(c >= 1_000_000 for _, c in spins)
    assert log[:3] == [spins[0], "record", "record"]
    assert ms == pytest.approx(8.0 / 4)  # median of 8, 4 and 10 ms over 4 calls


@pytest.mark.parametrize("b, n, symmetric, want_ms, bound_by", [
    # symmetric: the kernel computes N (N + 1) / 2 pairs and mirrors the rest,
    # so the bytes bind at 512 (73.7 MB over 3.35 TB/s)
    (64, 512, True, 4.0 * (64 * 512 * 50 + 512 + 64 * 512 * 512) / 3.35e9, "bytes"),
    # two leaves tensors: all N * N pairs, two operations each, over 67 TFLOP/s
    (64, 512, False, 2.0 * 64 * 512 * 512 * 50 / 67e9, "operations"),
    (64, 50, True, 4.0 * (64 * 50 * 50 + 50 + 64 * 50 * 50) / 3.35e9, "bytes"),
])
def test_k1_bound_counts_the_pairs_the_kernel_computes(b, n, symmetric, want_ms, bound_by):
    ms, by = k1_bound(b, n, n, 50, symmetric, masked=True)
    assert by == bound_by
    assert ms == pytest.approx(want_ms, rel=1e-12)
