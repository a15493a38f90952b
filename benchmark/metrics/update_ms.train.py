"""The mean device extent of the program's `sg.update` span in the traced
train_iters: the K-update call (`SACTrainer._update_fused`: the draws, K4,
the refresh of the actor's views), in ms."""
from benchmark.spans import mean_extent_ms

META = {"name": "update_ms.train", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "K-update call",
        "moves": "train_env_steps_per_s", "workloads": ["goal2p-sac"]}


def read(rec):
    return mean_extent_ms(rec, "sg.update")
