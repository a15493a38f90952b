"""Training CLI: SAC, TD3, DQN or PPO on any registered env, on the card, with
checkpoints, deterministic evaluation and a steps/s meter.

The port's counterpart of tools/train.py, with the same flags and meanings
where they apply.  Differences: `--physics` is the engine's ("kernel", the
default, "fixed" or "adaptive"); `--device` picks the device (the card by
default, `--device cpu` for the plain PyTorch twins); `--scan-chunk` is the
number of train_iters between host reads of the metrics; `--ckpt` names a
file (utils/checkpoint.py), which also holds the generators' states, so that
a resumed run continues as the uninterrupted one would.  A checkpoint resumes
a run of the same algorithm and configuration; SAC and TD3 also read the
other `--fused` setting's checkpoints, as tools/train.py does: a fused run
migrates an unfused checkpoint to the kernel layout ("migrated"), an unfused
run re-hydrates the parameters and Adam moments of a fused one
("re-hydrated").

    python -m space_gym_torch.train --env GoalContinuous2P-v0 --algo sac --iters 500
    python -m space_gym_torch.train --algo td3 --lanes 8192 --ckpt run1.pt
    python -m space_gym_torch.train ... --ckpt run1.pt --resume
    python -m space_gym_torch.train --algo ppo --device cpu --iters 2 --lanes 128 ...
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


class Evaluator:
    """Deterministic-policy evaluation over fresh lanes: the summed returns
    of the episodes that end within `n_steps`, and their count.  Its rollout
    is a `PolicyRollout` of the learner's parameters, which the trainers
    update in place: one captured graph on the card, replayed at every
    evaluation."""

    def __init__(self, trainer, n_steps: int, generator, lanes: int = 256):
        from .engine import PolicyRollout

        self.trainer = trainer
        self.generator = generator
        self.lanes = lanes
        self.collect = PolicyRollout(trainer.engine,
                                     lambda params, g, obs: trainer.eval_act(params, obs),
                                     n_steps)

    def __call__(self, params):
        state, obs = self.trainer.engine.reset(self.lanes, self.generator)
        with torch.no_grad():
            _, _, traj = self.collect(params, state, obs, self.generator)
            run = torch.zeros_like(traj.reward[0])
            total = torch.zeros((), dtype=run.dtype, device=run.device)
            for r, d in zip(traj.reward, traj.done):
                run = run + r
                total = total + torch.where(d, run, 0.0).sum()
                run = torch.where(d, 0.0, run)
        return float(total), int(traj.done.sum())


def _flax_flat(tree, prefix="") -> dict:
    """A nested flax tree -> {"p:['params']['MLP_0']...": array}, the keys
    `jax.tree_util.keystr` gives (the learner files of tools/train.py)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flax_flat(v, key))
        else:
            out["p:" + key] = np.asarray(v)
    return out


FLAX_KINDS = {"sac": "actor", "td3": "det_actor", "ppo": "ppo", "dqn": "dqn"}


def learner_arrays(algo: str, state) -> dict:
    """The compact learner snapshot of tools/train.py: the kernel layout of a
    fused learner (with log_alpha for SAC), else the policy's parameters as
    flattened flax arrays; both read by models.convert.load_learner_npz."""
    from .models import convert

    fused = getattr(state, "fused", None)
    if fused is not None:
        arrs = {f: np.asarray(x) for f, x in zip(fused._fields, convert.fused_to_numpy(fused))}
    else:
        params = state.params if algo in ("ppo", "dqn") else state.actor_params
        arrs = _flax_flat(convert.params_to_flax(params, FLAX_KINDS[algo]))
    if hasattr(state, "log_alpha"):
        arrs["log_alpha"] = state.log_alpha.detach().cpu().numpy()
    arrs["step"] = np.asarray(state.step, np.int32)
    return arrs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="GoalContinuous2P-v0")
    ap.add_argument("--algo", choices=["sac", "td3", "dqn", "ppo"], default="sac")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--rollout-len", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--updates-per-iter", type=int, default=4)
    ap.add_argument("--replay-rows", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hidden", type=int, default=256,
                    help="MLP hidden width (two layers); the fused kernels on the card take "
                         "128, 256, 384 and 512, the CPU any multiple of 128")
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--n-step", type=int, default=1,
                    help="SAC: n-step TD targets computed inside the rollout slab")
    ap.add_argument("--alpha-floor", type=float, default=0.0,
                    help="SAC: lower bound on the entropy temperature")
    ap.add_argument("--reward-scale", type=float, default=1.0,
                    help="SAC: reward multiplier entering the replay buffer")
    ap.add_argument("--target-entropy", type=float, default=None,
                    help="SAC: entropy target for the temperature loss (default -dim(A))")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction, default=None,
                    help="SAC/TD3: all K updates in one kernel launch (K4 for SAC, K6 for "
                         "TD3; the plain version on the CPU).  Default: on for td3, off for "
                         "sac, as tools/train.py")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-steps", type=int, default=600)
    ap.add_argument("--until-return", type=float, default=None,
                    help="stop (after saving the checkpoint) once an eval mean return "
                         "reaches this value")
    ap.add_argument("--ckpt", default=None, help="checkpoint file")
    ap.add_argument("--ckpt-full-every", type=int, default=1,
                    help="save the checkpoint every Nth eval instead of every eval")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--scan-chunk", type=int, default=25,
                    help="train_iters between host reads of the metrics")
    ap.add_argument("--physics", default="kernel", choices=["kernel", "fixed", "adaptive"],
                    help="engine physics: the kernels (default), or in plain PyTorch the "
                         "fixed-substep integrator or scipy's adaptive RK45")
    ap.add_argument("--obs-features", default=None, choices=["kepler", "goal", "dnc"],
                    help="append analytic obs features at the engine boundary; changes "
                         "obs_dim")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda), 'cpu' for the plain twins")
    args = ap.parse_args(argv)
    if args.fused is None:
        args.fused = args.algo == "td3"
    return args


def make_trainer(args):
    from . import get_config
    from .engine import EnvEngine
    from .models import SACConfig, SACTrainer, TD3Config, TD3Trainer
    from .models.dqn import DQNConfig, DQNTrainer
    from .models.ppo import PPOConfig, PPOTrainer

    eng = EnvEngine(get_config(args.env), physics=args.physics, obs_features=args.obs_features,
                    device=args.device)
    kw = dict(lanes=args.lanes, rollout_len=args.rollout_len, replay_rows=args.replay_rows,
              batch_size=args.batch_size, updates_per_iter=args.updates_per_iter, lr=args.lr,
              hidden=(args.hidden, args.hidden))
    if args.algo == "sac":
        return SACTrainer(eng, SACConfig(
            **kw, gamma=args.gamma, n_step=args.n_step, alpha_floor=args.alpha_floor,
            reward_scale=args.reward_scale, target_entropy=args.target_entropy,
            fused_updates=args.fused, fused_block=min(2048, args.batch_size)))
    if args.algo == "ppo":
        return PPOTrainer(eng, PPOConfig(lanes=args.lanes, rollout_len=args.rollout_len,
                                         lr=args.lr, gamma=args.gamma))
    if args.algo == "td3":
        return TD3Trainer(eng, TD3Config(**kw, fused_updates=args.fused,
                                         fused_block=min(2048, args.batch_size)))
    return DQNTrainer(eng, DQNConfig(**kw))


def resume(args, trainer, template: dict, gen, eval_gen):
    """The state of the checkpoint `args.ckpt`, its generators' states set
    into `gen` and `eval_gen`.  The run's own format is tried first; for SAC
    and TD3 then the other `--fused` setting's, which is bridged to this
    run's (tools/train.py:173-227)."""
    from .utils import checkpoint as ckpt

    state = template["state"]
    templates = [template]
    if args.algo in ("sac", "td3"):
        try:
            other = (state._replace(fused=None) if state.fused is not None
                     else trainer.migrate_to_fused(state))
            templates.append(dict(template, state=other))
        except ValueError:  # a width the fused layout does not take: no fused format
            pass
    errors = []
    for tpl in templates:
        try:
            restored = ckpt.restore(args.ckpt, tpl)
            break
        except ValueError as e:
            errors.append(str(e))
    else:
        raise SystemExit(f"checkpoint {args.ckpt} does not match this run's algorithm and "
                         f"configuration: {'; '.join(errors)}")
    state = restored["state"]
    gen.set_state(restored["generator"])
    eval_gen.set_state(restored["eval_generator"])
    if args.algo in ("sac", "td3"):
        if args.fused and state.fused is None:
            state = trainer.migrate_to_fused(state)
            print("migrated the unfused checkpoint's parameters and Adam moments to the fused "
                  "kernel layout", flush=True)
        elif not args.fused and state.fused is not None:
            state = trainer.rehydrate_from_fused(state)
            print("re-hydrated the parameters and Adam moments from the fused checkpoint",
                  flush=True)
    return state


def main(argv=None):
    from .utils import checkpoint as ckpt
    from .utils.profiling import ThroughputMeter

    args = parse_args(argv)
    trainer = make_trainer(args)
    state = trainer.init(args.seed)
    gen = trainer.generator(args.seed + 1)
    eval_gen = trainer.generator(args.seed + 2)

    def saved():
        return {"state": state, "generator": gen.get_state(), "eval_generator": eval_gen.get_state()}

    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        state = resume(args, trainer, saved(), gen, eval_gen)
        if getattr(state, "fused", None) is not None:
            state = trainer._refresh_from_fused(state)  # the actor as views of the fused state
        print(f"resumed from {args.ckpt} at step {state.step}", flush=True)

    steps_per_iter = args.lanes * args.rollout_len
    eval_params = ((lambda st: st.params) if args.algo in ("dqn", "ppo")
                   else (lambda st: st.actor_params))
    best_path = (args.ckpt + ".best.npz") if args.ckpt else None
    best_ret = -float("inf")
    if args.resume and best_path and os.path.exists(best_path):
        with np.load(best_path) as z:
            if "eval_return" in z:
                best_ret = float(z["eval_return"])
        print(f"best-so-far eval {best_ret:.2f} ({best_path})", flush=True)

    def save_best(st, **extra):
        arrs = learner_arrays(args.algo, st)
        arrs.update(obs_dim=np.asarray(trainer.engine.obs_dim),
                    obs_features=np.asarray(args.obs_features or ""), env_id=np.asarray(args.env),
                    **{k: np.asarray(v) for k, v in extra.items()})
        np.savez(best_path + ".tmp", **arrs)
        os.replace(best_path + ".tmp.npz", best_path)

    meter = ThroughputMeter()
    evaluate = None
    meter.tick(0)
    i = state.step
    while i < args.iters:
        nb = ((i // args.log_every) + 1) * args.log_every
        if args.eval_every:
            nb = min(nb, ((i // args.eval_every) + 1) * args.eval_every)
        nb = min(nb, args.iters)
        n = max(1, min(args.scan_chunk, nb - i))
        state, metrics = trainer.train_iters(state, gen, n)
        i += n
        m = {k: float(v) for k, v in metrics.items()}  # the host read
        meter.tick(n * steps_per_iter)
        if i % args.log_every == 0 or i >= args.iters:
            rate = meter.rate
            print(json.dumps(dict(iter=i, env_steps=i * steps_per_iter,
                                  steps_per_s=round(rate, 0) if rate == rate else None,
                                  **{k: round(v, 4) for k, v in m.items()})), flush=True)
        if args.eval_every and i % args.eval_every == 0:
            if evaluate is None:
                evaluate = Evaluator(trainer, args.eval_steps, eval_gen)
            ret_sum, ret_n = evaluate(eval_params(state))
            mean_ret = ret_sum / max(ret_n, 1)
            print(json.dumps(dict(iter=i, eval_mean_return=round(mean_ret, 2),
                                  eval_episodes=ret_n)), flush=True)
            if best_path and mean_ret > best_ret:
                best_ret = mean_ret
                save_best(state, eval_return=mean_ret, eval_iter=i)
                print(json.dumps(dict(iter=i, best_learner=best_path,
                                      eval_mean_return=round(mean_ret, 2))), flush=True)
            if args.ckpt and (i // args.eval_every) % max(1, args.ckpt_full_every) == 0:
                ckpt.save(args.ckpt, saved())
                print(json.dumps(dict(iter=i, checkpoint=args.ckpt)), flush=True)
            if args.until_return is not None and mean_ret >= args.until_return:
                print(json.dumps(dict(iter=i, target_return=args.until_return, reached=True)),
                      flush=True)
                break
    if args.ckpt:
        ckpt.save(args.ckpt, saved())
        print(json.dumps(dict(checkpoint=args.ckpt, final=True)), flush=True)
    return state


if __name__ == "__main__":
    main()
