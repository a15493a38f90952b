"""Device time per env step in every kernel but K3 (the bulk draw, the
policy's draw, copies and sums around it), in the traced window, over the
steps whose K3 launch the profiler saw; nothing when it saw none."""
META = {"name": "glue_ms.collect", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "glue around K3", "moves": "env_steps_per_s"}


def read(rec):
    t = rec.trace
    if t is None or t["hits"] == 0:
        return None
    other = sum(s for name, (n, s) in t["kernels"].items() if rec.mode.KERNEL not in name)
    return 1e3 * other / t["hits"]
