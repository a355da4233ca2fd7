"""The trace's arithmetic: busy time as the union of kernel intervals, idle
gaps named by the span they fall in, device time inside a span."""
from portbench.trace import Trace


def _trace():
    kernels = [("k_a", 10, 30), ("k_b", 20, 40), ("wkv_out", 60, 70),
               ("k_c", 90, 95)]
    spans = [("wave 0", 0, 100), ("optimizer", 50, 80)]
    return Trace(kernels, spans, 0, 100)


def test_busy_is_the_union_of_kernels():
    tr = _trace()
    assert tr.merged() == [(10, 40), (60, 70), (90, 95)]
    assert tr.busy_s == 45e-9
    assert tr.window_s == 100e-9


def test_idle_gaps_are_named_and_longest_first():
    gaps = Trace.idle_gaps(_trace())
    assert gaps == [["optimizer, before wkv_out", 20e-9],
                    ["wave 0, before k_c", 20e-9],
                    ["wave 0, before k_a", 10e-9],
                    ["wave 0, before the window's end", 5e-9]]


def test_device_time_by_span_and_name():
    tr = _trace()
    assert tr.device_time_s(50, 80) == 10e-9
    assert tr.device_time_s(0, 100, ("wkv_",)) == 10e-9
    assert tr.top_ops(2) == [["k_a", 20e-9], ["k_b", 20e-9]]


def test_a_tracer_stopped_by_its_limit_marks_its_trace_cut():
    from portbench.trace import Spans, Tracer

    class Prof:
        def stop(self):
            pass

        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return []

    tracer = Tracer(Spans(), lambda: None, limit_s=0.0)
    tracer.prof, tracer.t0 = Prof(), 0
    tracer.poll()
    assert tracer.prof is None and tracer.trace.cut
    tracer.prof, tracer.t0 = Prof(), 0
    tracer.stop()
    assert not tracer.trace.cut
