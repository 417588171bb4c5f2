"""1 - (union of kernel, copy and set intervals) / the profiled window, %."""


def read(out):
    dt = out.rec.device_trace
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s) if dt and dt.window_s > 0 else None
