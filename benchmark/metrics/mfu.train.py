"""The train_iter's share of the chip's peak: its network arithmetic (the
rollout's policy forwards and the updates' forward, backward, Adam and
polyak, counted from the shapes; each product at the peak of the precision
the configuration states) over the traced time per train_iter, in percent."""
from benchmark.roofline import least_seconds

META = {"name": "mfu.train", "kind": "per_layer", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "whole train_iter", "moves": "train_env_steps_per_s"}


def read(rec):
    t = rec.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * least_seconds(0, rec.mode.iter_ops()) * t["calls"] / t["window_s"]
