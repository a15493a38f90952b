"""Print BENCHMARK.json as the files under benchmark/ define it, or write it.

    python3 -m benchmark.manifest            # print
    python3 -m benchmark.manifest --write    # write BENCHMARK.json at the root
"""
import json
import os
import sys

from .registry import HERE, Registry


def render() -> str:
    return json.dumps(Registry().manifest(), indent=2) + "\n"


if __name__ == "__main__":
    text = render()
    if "--write" in sys.argv[1:]:
        with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"), "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
