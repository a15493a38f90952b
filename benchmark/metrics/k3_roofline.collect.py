"""The full-step kernel K3's share of its roofline: the least time of an env
step of the traced window (benchmark/roofline.py) over K3's device time per
launch the profiler saw, in percent; nothing when the trace holds no K3
launch."""
META = {"name": "k3_roofline.collect", "kind": "per_layer", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "full-step kernel K3", "moves": "env_steps_per_s"}


def read(rec):
    t = rec.trace
    if t is None:
        return None
    k3 = sum(s for name, (n, s) in t["kernels"].items() if rec.mode.KERNEL in name)
    if t["hits"] == 0 or k3 <= 0:
        return None
    steps = t["calls"] * rec.mode.KERNEL_PER_CALL
    least_per_step = rec.mode.least_seconds(t["calls"], t["ended"]) / steps
    return 100.0 * least_per_step * t["hits"] / k3
