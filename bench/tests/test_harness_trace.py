"""The reduction of a profiled stretch from raw events, on synthetic
events: the device's busy union, the multiply's device operations found
through either link to their launch, and the idle gaps by host phase."""
import types

import pytest
import torch

from benchlib.trace import summarise

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class E:
    def __init__(self, name, start, dur, dev=CPU, corr=0, linked=0,
                 thread=1, annotation=False):
        self._v = (name, start, dur, dev, corr, linked, thread, annotation)

    def is_user_annotation(self):
        return self._v[7]

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def stretch_events():
    return [
        E("bench/stretch", 0, 1000),
        E("bench/flush", 10, 200),
        E("aten::stack", 20, 50, corr=11),
        E("cudaLaunchKernel", 30, 5, corr=900),
        E("bench/multiply", 100, 100),
        E("aten::index_add_", 150, 20, corr=12),
        E("cudaLaunchKernel", 120, 5, corr=901),
        E("cudaLaunchKernel", 160, 5, corr=902),
        E("bench/wait", 300, 500),
        E("cudaEventSynchronize", 310, 480, corr=903),
        # device: the stack's copy, a ctypes kernel (runtime link), the
        # un-permute (op link), a late kernel half outside the stretch
        E("stack_kernel", 100, 100, dev=CUDA, corr=900, linked=11),
        E("sellcs_items_kernel", 200, 300, dev=CUDA, corr=901),
        E("index_add_kernel", 450, 100, dev=CUDA, corr=902, linked=12),
        E("late_kernel", 900, 400, dev=CUDA, corr=950),
        # the profiler's device-side mirrors of host ranges: not operations
        E("bench/multiply", 120, 430, dev=CUDA, annotation=True),
        E("bench/flush", 100, 450, dev=CUDA),
    ]


def test_busy_multiply_and_gaps():
    t = summarise(prof(stretch_events()))
    assert t.window_s == pytest.approx(1000e-9)
    # [100, 550) and [900, 1000) are busy
    assert t.busy_s == pytest.approx(550e-9)
    # [200, 500) and [450, 550) overlap: their union, not their sum
    assert t.multiply_device_s == pytest.approx(350e-9)
    # one found through its host operation, one through its runtime call
    assert t.multiply_ops == 2
    names = dict(t.device_ops)
    assert names["sellcs_items_kernel"] == pytest.approx(300e-9)
    assert names["late_kernel"] == pytest.approx(100e-9)   # inside only
    gaps = dict(t.idle_gaps)
    # [0, 100): the flush's stack; [550, 900): the wait
    assert gaps["bench/flush > aten::stack"] == pytest.approx(100e-9)
    assert gaps["bench/wait > cudaEventSynchronize"] == pytest.approx(
        350e-9)
    assert sum(gaps.values()) + t.busy_s == pytest.approx(t.window_s)


def test_nothing_to_read_gives_nothing():
    assert summarise(prof([E("bench/stretch", 0, 10)])) is None
    assert summarise(prof([E("x", 0, 10, dev=CUDA)])) is None
    # device work wholly outside the stretch
    assert summarise(prof([E("bench/stretch", 0, 10),
                           E("k", 20, 5, dev=CUDA)])) is None


def test_launch_outside_the_multiply_is_not_counted():
    evs = [E("bench/stretch", 0, 100), E("bench/multiply", 50, 10),
           E("cudaLaunchKernel", 10, 2, corr=5),
           E("k", 20, 10, dev=CUDA, corr=5)]
    t = summarise(prof(evs))
    assert t.multiply_device_s == 0 and t.multiply_ops == 0
