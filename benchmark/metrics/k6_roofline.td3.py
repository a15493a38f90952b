"""The fused TD3 K-update kernel K6's share of its roofline: the least time of
one launch's work (benchmark/roofline.py::td3_work, with the launch's delayed
updates counted by the benchmark from the traffic) over K6's device time per
launch, in percent; nothing when the trace holds no K6 launch."""
from benchmark.roofline import least_seconds

META = {"name": "k6_roofline.td3", "kind": "per_layer", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "fused TD3 K-update kernel K6",
        "moves": "train_env_steps_per_s", "workloads": ["goal2p-td3"]}


def read(rec):
    t = rec.trace
    if t is None:
        return None
    hits = [(n, s) for name, (n, s) in t["kernels"].items() if rec.mode.KERNEL in name]
    launches, seconds = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * least_seconds(*rec.mode.k6_work()) * launches / seconds
