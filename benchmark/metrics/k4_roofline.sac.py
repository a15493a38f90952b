"""The fused SAC K-update kernel K4's share of its roofline: the least time of
one launch's work (benchmark/roofline.py::sac_work) over K4's device time per
launch, in percent; nothing when the trace holds no K4 launch."""
from benchmark.roofline import least_seconds

META = {"name": "k4_roofline.sac", "kind": "per_layer", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "K-update kernel K4",
        "moves": "train_env_steps_per_s"}


def read(rec):
    t = rec.trace
    if t is None:
        return None
    hits = [(n, s) for name, (n, s) in t["kernels"].items() if rec.mode.KERNEL in name]
    launches, seconds = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * least_seconds(*rec.mode.k4_work()) * launches / seconds
