"""The device's idle share in the traced training window: 1 - the union of
its activity intervals over the window's length, in percent."""
META = {"name": "device_idle.train", "kind": "per_layer", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "train_env_steps_per_s"}


def read(rec):
    t = rec.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
