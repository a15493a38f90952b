"""The mean device time from one traced `sg.graph.call` span's device end to
the next one's device start, over the consecutive calls of one window: the
device waiting for the host between captured rollouts, in ms."""
from benchmark.spans import mean_gap_ms

META = {"name": "call_gap_ms.collect", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "host between captured calls",
        "moves": "env_steps_per_s", "workloads": ["goal2p-collect", "goal4p-collect"]}


def read(rec):
    return mean_gap_ms(rec, "sg.graph.call")
