"""The mean device extent of the program's `sg.insert` span in the traced
train_iters: the rollout's n-step slab and its replay ring insert
(models/replay.py), in ms."""
from benchmark.spans import mean_extent_ms

META = {"name": "insert_ms.train", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "replay insert",
        "moves": "train_env_steps_per_s", "workloads": ["goal2p-sac"]}


def read(rec):
    return mean_extent_ms(rec, "sg.insert")
