"""The mean device time from one traced `sg.train_iter` span's device end to
the next one's device start, over the consecutive pairs of one window: the
device waiting for the host between iterations, in ms."""
from benchmark.spans import mean_gap_ms

META = {"name": "iter_gap_ms.train", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "host between train_iters",
        "moves": "train_env_steps_per_s", "workloads": ["goal2p-sac"]}


def read(rec):
    return mean_gap_ms(rec, "sg.train_iter")
