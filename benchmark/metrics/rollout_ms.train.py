"""The mean device extent of the program's `sg.rollout` span in the traced
train_iters: the rollout of `OffPolicyTrainer._rollout` (the trainer's
PolicyRollout, one captured graph), in ms."""
from benchmark.spans import mean_extent_ms

META = {"name": "rollout_ms.train", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "rollout in train_iter",
        "moves": "train_env_steps_per_s", "workloads": ["goal2p-sac"]}


def read(rec):
    return mean_extent_ms(rec, "sg.rollout")
