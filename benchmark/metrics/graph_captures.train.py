"""The CUDA graphs captured in the traced train_iters (`sg.graph.capture`
spans): the trainer's PolicyRollout captures again only when its actor's
parameters or its generator are other tensors, so anything above 0 is work
done again.  Nothing without traced `sg.train_iter` spans."""
from benchmark.spans import program_spans

META = {"name": "graph_captures.train", "kind": "per_layer", "unit": "count",
        "better": "lower", "source": "program_span", "layer": "rollout graph cache",
        "moves": "train_env_steps_per_s", "workloads": ["goal2p-sac"]}


def read(rec):
    if not program_spans(rec, "sg.train_iter"):
        return None
    return len(program_spans(rec, "sg.graph.capture"))
