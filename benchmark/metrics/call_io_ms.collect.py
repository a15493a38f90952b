"""The mean device extent of a traced `sg.graph.call` span less that of its
`sg.graph.replay`: the captured call's boundary (`to_carry`, the copies into
the graph's static buffers, the clones of its outputs, `from_carry`), in ms."""
from benchmark.spans import extent_ms, program_spans

META = {"name": "call_io_ms.collect", "kind": "per_layer", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "captured call boundary",
        "moves": "env_steps_per_s", "workloads": ["goal2p-collect", "goal4p-collect"]}


def read(rec):
    calls = {s["id"]: s for s in program_spans(rec, "sg.graph.call") or []
             if s["dev_start_ns"] is not None}
    io = [extent_ms(calls[r["parent_id"]]) - extent_ms(r)
          for r in program_spans(rec, "sg.graph.replay") or []
          if r["parent_id"] in calls and r["dev_start_ns"] is not None]
    return sum(io) / len(io) if io else None
