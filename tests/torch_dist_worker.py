"""Worker process for the two-process torch.distributed CPU test
(tests/test_torch_distributed.py).  Not a pytest module.

Both ranks join a gloo process group through `init_distributed`, then, for
the (data 2 x model 1) mesh and the (data 1 x model 2) mesh in turn, run
fused SAC (lanes 32, K=2, minibatches by `replay_sample_rows`) for two
train_iters and PPO for one, and print digests of the learner states, which
the parent holds equal across the ranks.  Each rank also runs the same
trainers without a mesh (the one-process run) and prints how far its state
and its lanes are from it, and how far the two meshes' states are apart.

Usage: python tests/torch_dist_worker.py <rank> <nproc> <coordinator_port>
"""
import hashlib
import os
import sys


def main():
    rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import torch

    torch.set_num_threads(1)
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine
    from space_gym_torch.models import SACConfig, SACTrainer
    from space_gym_torch.models.ppo import PPOConfig, PPOTrainer
    from space_gym_torch.parallel import (init_distributed, local_lane_slice, make_mesh, place,
                                          trainer_state_shardings)
    from space_gym_torch.parallel.mesh import gather_model

    idx = init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=rank,
                           device="cpu")
    assert idx == rank, (idx, rank)
    assert torch.distributed.get_backend() == "gloo"
    assert torch.distributed.get_world_size() == nproc
    assert local_lane_slice(32) == slice(rank * 16, (rank + 1) * 16)

    cfg = get_config("GoalContinuous2P-v0")
    sac_cfg = SACConfig(lanes=32, rollout_len=4, replay_rows=16, batch_size=96,
                        updates_per_iter=2, warmup_rows=4, hidden=(128, 128),
                        fused_updates=True, fused_block=24)
    ppo_cfg = PPOConfig(lanes=128, rollout_len=2, epochs=1, minibatches=2)

    def run(make, mesh, iters):
        eng = EnvEngine(cfg, device="cpu", substeps=1, refine_iters=8, mesh=mesh)
        tr = make(eng)
        st = tr.init(0)
        if mesh is not None:
            st = place(st, trainer_state_shardings(st, mesh, mesh.model_size), mesh)
        g = tr.generator(1)
        for _ in range(iters):
            st, m = tr.train_iter(st, g)
        if mesh is not None:
            st = gather_model(st, tr.shardings, mesh)  # whole parameters for the digests
        return st, {k: float(v) for k, v in m.items()}

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    def maxdiff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    sac = lambda e: SACTrainer(e, sac_cfg)  # noqa: E731
    ppo = lambda e: PPOTrainer(e, ppo_cfg)  # noqa: E731
    one_sac, _ = run(sac, None, 2)
    one_ppo, _ = run(ppo, None, 1)
    fused = {}
    ppo_params = {}
    for name, model_parallel in (("d2m1", 1), ("d1m2", 2)):
        mesh = make_mesh(nproc, model_parallel=model_parallel)
        st, m = run(sac, mesh, 2)
        pst, pm = run(ppo, mesh, 1)
        fused[name] = list(st.fused[:6])
        ppo_params[name] = [pst.params[k] for k in sorted(pst.params)]
        print(f"FUSED_CHECKSUM {name} {digest(fused[name])} counts {tuple(st.fused[6:])}",
              flush=True)
        print(f"CHECKSUM {name} {digest(ppo_params[name])} "
              f"{digest([st.actor_params[k] for k in sorted(st.actor_params)])}", flush=True)
        print(f"METRICS {name} sac {sorted(m.items())} ppo {sorted(pm.items())}", flush=True)
        per = 32 // mesh.data_size
        lanes = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
        one_ppo_params = [one_ppo.params[k] for k in sorted(one_ppo.params)]
        one_lanes = [one_sac.obs[lanes], one_sac.env_state.y[lanes]]
        print(f"ONEPROC {name} params {maxdiff(fused[name], one_sac.fused[:6]):.3e} "
              f"ppo {maxdiff(ppo_params[name], one_ppo_params):.3e} "
              f"lanes {maxdiff([st.obs, st.env_state.y], one_lanes):.3e} "
              f"ring {maxdiff([st.replay.data], [one_sac.replay.data[:, :, lanes]]):.3e}",
              flush=True)
    print(f"LAYOUTS params {maxdiff(fused['d2m1'], fused['d1m2']):.3e} "
          f"ppo {maxdiff(ppo_params['d2m1'], ppo_params['d1m2']):.3e}", flush=True)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
