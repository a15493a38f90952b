"""The 95th percentile of every train_iter in the window, each timed on the
device by a CUDA event recorded after it (the first from one before it)."""
import statistics

META = {"name": "train_iter_p95_ms", "kind": "end_to_end", "unit": "ms", "better": "lower",
        "bound": 0.047, "source": "device_trace"}


def read(rec):
    if rec.window is None or len(rec.window["call_ms"]) < 20:
        return None
    return statistics.quantiles(rec.window["call_ms"], n=20)[18]
