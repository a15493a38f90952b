"""Set-up time: the process's start to the first timed call (benchmark/harness.py)."""
META = {"name": "setup_s", "kind": "end_to_end", "unit": "s", "better": "lower",
        "bound": 0.25, "source": "host_clock"}


def read(rec):
    return rec.setup_s
