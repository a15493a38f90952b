"""Two-process torch.distributed exercise on the CPU, after
tests/test_distributed.py (the JAX package's fake-cluster test).

Spawns two ranks (tests/torch_dist_worker.py) joined over gloo through
`parallel.init_distributed`.  Each runs fused SAC (lanes 32, K=2,
minibatches by `replay_sample_rows`: the all_gather along lanes) for two
train_iters and PPO (rollout batch gathered before its epoch) for one, on a
(data 2 x model 1) mesh and on a (data 1 x model 2) mesh, and prints
digests of the learner states, which must be equal across the ranks bit for
bit: every rank runs the same update on the same gathered batch.  Each rank
also runs the trainers without a mesh; its state must equal that
one-process run within 1e-5 (parameters, its lanes, its block of the ring),
and the two meshes' states each other within 1e-5 (PyTorch's CPU maths
may round a lane by its position in a tensor: equal bits are not promised
across lane counts, though this run has had them).
"""
import os
import re
import socket
import subprocess
import sys

TOL = 1e-5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_train_step():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests", "torch_dist_worker.py"),
             str(rank), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=repo, env=env)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "WORKER_OK" in out, f"rank {rank} incomplete:\n{out}"

    def field(out, tag):
        return [line for line in out.splitlines() if line.startswith(tag + " ")]

    for tag in ("CHECKSUM", "METRICS", "FUSED_CHECKSUM"):
        a, b = field(outs[0][1], tag), field(outs[1][1], tag)
        assert len(a) == 2 and a == b, f"{tag} diverged across ranks: {a} vs {b}"
    for rank, (_, out, _) in enumerate(outs):
        lines = field(out, "ONEPROC") + field(out, "LAYOUTS")
        assert len(lines) == 3, out
        for line in lines:
            diffs = [float(x) for x in re.findall(r"\d\.\d+e[-+]\d+", line)]
            assert diffs and max(diffs) <= TOL, f"rank {rank}: {line}"
