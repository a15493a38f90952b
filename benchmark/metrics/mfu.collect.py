"""The whole env step's share of the chip's peak: the least time of the traced
window's steps, counted from the work they must do (benchmark/roofline.py),
over the window's length, in percent."""
META = {"name": "mfu.collect", "kind": "per_layer", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "whole env step", "moves": "env_steps_per_s"}


def read(rec):
    t = rec.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * rec.mode.least_seconds(t["calls"], t["ended"]) / t["window_s"]
