"""Training rate: lanes x rollout length of every train_iter in the window
over the window's wall time, from its start to the end of the last
iteration, which ends in a device synchronise."""
META = {"name": "train_env_steps_per_s", "kind": "end_to_end", "unit": "steps/s",
        "better": "higher", "bound": 0.026, "source": "host_clock"}


def read(rec):
    if rec.window is None:
        return None
    return rec.window["work"] / rec.window["seconds"]
