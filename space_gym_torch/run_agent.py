"""Replay a trained policy in a single env, with GIFs of its episodes.

The port's counterpart of examples/run_agent.py, with its flags.  The
learner comes from a checkpoint of `python -m space_gym_torch.train`
(`--ckpt run.pt`) or from a learner file (`--ckpt docs/goal2p_sac_best.npz`:
a fused SAC/TD3 learner, or the flattened flax parameters of a PPO, DQN or
actor network, read by models/convert.py::load_learner_npz).  Episodes run
through `make(env, physics="host")`, the reference's own integrator bit for
bit, with the deterministic policy on the card (`--device cpu` for the
CPU); frames go through the port's renderer into one GIF per episode.

    python -m space_gym_torch.run_agent --ckpt docs/goal2p_sac_best.npz --episodes 2 \
        --out build/replays
    python -m space_gym_torch.run_agent --ckpt run.pt --algo td3 --no-gif

`--display` (a live window) is not offered: a window needs a human in front
of it.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

# the first-layer kernel of each algorithm's policy network, in the port's names
FIRST_LAYER = {"sac": "mlp.layers", "td3": "mlp.layers", "ppo": "torso.layers",
               "dqn": "layers"}
# what load_learner_npz calls the network of a parameter file, by algorithm
NPZ_KIND = {"sac": ("sac", "actor"), "td3": ("td3", "det_actor"), "ppo": ("ppo",),
            "dqn": ("dqn",)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--env", default="GoalContinuous2P-v0")
    ap.add_argument("--algo", choices=["sac", "td3", "ppo", "dqn"], default="sac")
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/replays", help="directory of the GIFs")
    ap.add_argument("--display", action="store_true", help="live window instead of GIFs")
    ap.add_argument("--every", type=int, default=2, help="render every k-th step")
    ap.add_argument("--no-gif", action="store_true",
                    help="skip rendering and GIF writing (scoring only)")
    ap.add_argument("--obs-features", default=None, choices=["kepler", "goal", "dnc"],
                    help="must match the learner's training --obs-features (the actor's "
                         "input includes the appended features)")
    ap.add_argument("--device", default=None,
                    help="torch device of the policy; default the card, 'cpu' for the CPU")
    return ap.parse_args(argv)


def policy_params(args, obs_dim: int, device) -> dict:
    """The policy network's parameter dict of `args.ckpt` on `device`, after
    the checks of examples/run_agent.py: the algorithm and the obs_dim (and
    obs_features) the learner was trained with."""
    from .models import convert, fused_sac, fused_td3

    if args.ckpt.endswith(".npz"):
        learner, _, meta = convert.load_learner_npz(args.ckpt, device)
        if "obs_dim" in meta and int(meta["obs_dim"]) != obs_dim:
            raise SystemExit(
                f"npz was trained at obs_dim {int(meta['obs_dim'])} but the replay engine has "
                f"obs_dim {obs_dim} — pass the matching --obs-features (or migrate via "
                "python -m space_gym_torch.restore_learner)")
        if "obs_features" in meta and (str(meta["obs_features"]) or None) != args.obs_features:
            raise SystemExit(
                f"npz was trained with obs_features={str(meta['obs_features']) or None!r}; "
                f"pass the same --obs-features (got {args.obs_features!r})")
        kind = meta["kind"]
        if kind not in NPZ_KIND[args.algo]:
            if kind in ("sac", "td3") and args.algo in ("ppo", "dqn"):
                raise SystemExit("fused npz learners are SAC/TD3 format")
            raise SystemExit(f"{args.ckpt} holds a {kind} learner; pass the --algo it was "
                             "trained with")
        if kind in ("sac", "td3"):
            layout = (fused_sac if kind == "sac" else fused_td3).build(learner.w.shape[1])
            return {k: v.clone() for k, v in
                    layout.unpack_actor(learner.w, learner.vec, obs_dim, 2).items()}
        return learner
    # a training checkpoint: its leaves are those of {"eval_generator", "generator",
    # "state"} (utils/checkpoint.py, keys sorted), and the state's first field is
    # the policy's parameter dict (actor_params, or params for PPO and DQN), keys sorted
    leaves = torch.load(os.path.abspath(args.ckpt), map_location="cpu",
                        weights_only=True)["leaves"]
    names = _policy_names(args.algo, obs_dim)
    params = dict(zip(names, leaves[2:2 + len(names)]))
    if len(params) != len(names) or not all(isinstance(v, torch.Tensor)
                                            for v in params.values()):
        raise SystemExit(f"{args.ckpt}: not a {args.algo} training checkpoint")
    return {k: v.to(device) for k, v in params.items()}


def _policy_names(algo: str, obs_dim: int) -> list:
    """The sorted parameter names of the algorithm's policy network."""
    from .models import networks

    nets = {"sac": lambda: networks.TanhGaussianActor(obs_dim, 2, (128, 128)),
            "td3": lambda: networks.DeterministicActor(obs_dim, 2, (128, 128)),
            "ppo": lambda: networks.GaussianActorValue(obs_dim, 2, (64, 64)),
            "dqn": lambda: networks.MLP(obs_dim, (128, 128, 6))}
    return sorted(nets[algo]().state_dict())


def make_trainer(algo: str, engine, hidden: tuple):
    """A trainer of the algorithm at a tiny configuration: only its networks
    and `eval_act` are used."""
    from .models.dqn import DQNConfig, DQNTrainer
    from .models.ppo import PPOConfig, PPOTrainer
    from .models.sac import SACConfig, SACTrainer
    from .models.td3 import TD3Config, TD3Trainer

    kw = dict(lanes=16, rollout_len=4, replay_rows=8, batch_size=32, updates_per_iter=1,
              hidden=hidden)
    if algo == "ppo":
        return PPOTrainer(engine, PPOConfig(lanes=128, rollout_len=8, epochs=1, minibatches=2,
                                            hidden=hidden))
    if algo == "dqn":
        return DQNTrainer(engine, DQNConfig(**kw))
    return (SACTrainer(engine, SACConfig(**kw)) if algo == "sac"
            else TD3Trainer(engine, TD3Config(**kw)))


def hidden_of(params: dict, algo: str) -> tuple:
    """The two hidden widths of a policy's parameter dict."""
    first = FIRST_LAYER[algo]
    return (params[f"{first}.0.kernel"].shape[1], params[f"{first}.1.kernel"].shape[1])


def write_gif(path: str, frames) -> None:
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=50, loop=0)


def main(argv=None):
    args = parse_args(argv)
    if args.display:
        raise NotImplementedError("--display needs a window and a human in front of it; "
                                  "write GIFs instead (the default)")
    from . import get_config, make
    from .engine import EnvEngine
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    eng = EnvEngine(get_config(args.env), obs_features=args.obs_features, device=device)
    params = policy_params(args, eng.obs_dim, device)
    first = params.get(f"{FIRST_LAYER[args.algo]}.0.kernel")
    if first is None:
        raise SystemExit(f"{args.ckpt}: the parameters do not match the --algo {args.algo} "
                         "network; pass the algo the learner was trained with")
    if first.shape[0] != eng.obs_dim:
        raise SystemExit(f"the learner takes obs_dim {first.shape[0]}, the replay engine has "
                         f"{eng.obs_dim}; pass the matching --obs-features")
    trainer = make_trainer(args.algo, eng, hidden_of(params, args.algo))

    env = make(args.env, physics="host")
    env.seed(args.seed)
    if not args.no_gif:
        os.makedirs(args.out, exist_ok=True)
    returns, steps, act_s, t0 = [], 0, 0.0, time.perf_counter()
    for ep in range(args.episodes):
        obs = env.reset()
        frames = []
        total, done, t = 0.0, False, 0
        while not done:
            a0 = time.perf_counter()
            ob = torch.as_tensor(np.asarray(obs, np.float32)[None], device=device)
            if args.obs_features:
                ob = eng._augment_obs(ob)
            a = trainer.eval_act(params, ob)[0].cpu().numpy()
            act_s += time.perf_counter() - a0
            act = int(a) if args.algo == "dqn" else a.astype(np.float32)
            obs, r, done, _ = env.step(act)
            total += r
            if not args.no_gif and t % args.every == 0:
                frames.append(env.render(mode="rgb_array"))
            t += 1
        steps += t
        returns.append(total)
        print(f"episode {ep}: return {total:.1f} steps {t}")
        if frames:
            path = os.path.join(args.out, f"{args.env}_ep{ep}.gif")
            write_gif(path, frames)
            print(f"  wrote {path} ({len(frames)} frames)")
    wall = time.perf_counter() - t0
    print(f"mean return: {np.mean(returns):.1f} +- {np.std(returns):.1f}")
    print(f"ms per step: {1e3 * wall / max(steps, 1):.4f} ({steps} steps; the policy "
          f"{1e3 * act_s / max(steps, 1):.4f} of it on {device})", flush=True)
    return returns


if __name__ == "__main__":
    main()
