"""Collection rate: lanes x steps of every call in the window over the
window's wall time, which ends in a device synchronise."""
META = {"name": "env_steps_per_s", "kind": "end_to_end", "unit": "steps/s", "better": "higher",
        "bound": 0.06, "source": "host_clock"}


def read(rec):
    if rec.window is None:
        return None
    return rec.window["work"] / rec.window["seconds"]
