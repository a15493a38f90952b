"""Replaying a trained learner with the port: `python -m
space_gym_torch.run_agent` and `python -m space_gym_torch.restore_learner`,
the counterparts of examples/run_agent.py and tools/restore_learner.py.

* The deterministic action tanh(mean) of the SAC learner in
  docs/goal2p_sac_best.npz, on the port, equals the JAX actor's (the flax
  network on space_gym_tpu's unpack_actor) on the same observations (fresh
  lanes and their next steps) within atol 1e-6 and rtol 1e-5: float32 on
  both sides, the 256-term sums of the hidden layers taken in other orders
  (one action in a thousand was 1.3e-6 off, 1.4e-5 of its value).  Whole
  returns are not compared: one ulp of difference in an action sends an
  episode elsewhere.
* A one-episode `--no-gif` replay on the CPU prints the reference's lines,
  and one with GIFs writes them; the obs_dim and obs_features checks refuse
  a learner of another featurization.
* `restore_learner.expand_first_layer` equals tools/restore_learner.py's on
  the same numpy trees (converted by models/convert.py); the migrated
  learner computes the old actor's actions whatever the new feature columns
  hold; its checkpoint resumes through `space_gym_torch.train --resume`.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_gym_tpu.models import fused_sac as jfused
from space_gym_tpu.models import networks as jnetworks

from space_gym_torch import run_agent, restore_learner, train
from space_gym_torch.models import convert, fused_sac
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOAL = os.path.join(REPO, "docs", "goal2p_sac_best.npz")
KEPLER = os.path.join(REPO, "docs", "kepler_sac_learner_r2c.npz")


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "restore_learner_tool", os.path.join(REPO, "tools", "restore_learner.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deterministic_actions_equal_jax():
    args = run_agent.parse_args(["--ckpt", GOAL, "--device", "cpu"])
    z = np.load(GOAL)
    obs_dim = int(z["obs_dim"])
    params = run_agent.policy_params(args, obs_dim, torch.device("cpu"))
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu")
    tr = run_agent.make_trainer("sac", eng, run_agent.hidden_of(params, "sac"))
    # the observations of fresh lanes and of their next 3 steps (numpy-seeded uniforms)
    rng = np.random.default_rng(0)
    state, o = eng.reset(128, u=torch.as_tensor(rng.random((128, eng.n_reset_rand)),
                                                 dtype=torch.float32))
    seen = [o]
    for _ in range(3):
        a = torch.as_tensor(rng.uniform(-1, 1, (128, 2)), dtype=torch.float32)
        u = torch.as_tensor(rng.random((128, eng.n_step_rand)), dtype=torch.float32)
        state, ts = eng.step(state, a, u=u)
        seen.append(ts.obs)
    obs = torch.cat(seen).numpy()
    got = tr.eval_act(params, torch.as_tensor(obs)).numpy()
    jparams = jfused.unpack_actor(jnp.asarray(z["w"]), jnp.asarray(z["vec"]), obs_dim, 2)
    mean, _ = jnetworks.TanhGaussianActor(2, (256, 256)).apply(jparams, jnp.asarray(obs))
    want = np.asarray(jnp.tanh(mean))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_replay_one_episode_on_the_cpu(capsys, tmp_path):
    returns = run_agent.main(["--ckpt", GOAL, "--no-gif", "--episodes", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(returns) == 1 and np.isfinite(returns[0])
    assert out.startswith("episode 0: return ") and "mean return: " in out
    assert "ms per step: " in out
    gif_dir = tmp_path / "gifs"
    run_agent.main(["--ckpt", GOAL, "--episodes", "1", "--every", "40", "--device", "cpu",
                    "--out", str(gif_dir)])
    assert (gif_dir / "GoalContinuous2P-v0_ep0.gif").stat().st_size > 0
    with pytest.raises(SystemExit, match="obs_dim"):
        run_agent.main(["--ckpt", GOAL, "--no-gif", "--obs-features", "goal", "--device", "cpu"])
    with pytest.raises(SystemExit, match="SAC/TD3"):
        run_agent.main(["--ckpt", GOAL, "--no-gif", "--algo", "ppo", "--device", "cpu"])
    with pytest.raises(NotImplementedError):
        run_agent.main(["--ckpt", GOAL, "--display", "--device", "cpu"])


def test_expand_first_layer_equals_jax():
    tool = jax_tool()
    rng = np.random.default_rng(3)
    old_d, new_d, h = 10, 22, 128
    layout = fused_sac.build(h)
    actor = {k: torch.as_tensor(rng.normal(size=tuple(v.shape)).astype(np.float32))
             for k, v in layout.unpack_params(layout.adam_init(layout.pack_params(
                 *_zero_learner(layout, old_d))).m, old_d)[0].items()}
    critic = {k: torch.as_tensor(rng.normal(size=tuple(v.shape)).astype(np.float32))
              for k, v in _zero_learner(layout, old_d)[1].items()}
    for params, kind, has_action in ((actor, "actor", False), (critic, "critic", True)):
        want = jax.tree.map(np.asarray, tool.expand_first_layer(
            convert.params_to_flax(params, kind), old_d, new_d, has_action))
        got = convert.params_to_flax(
            restore_learner.expand_first_layer(params, old_d, new_d, has_action), kind)
        flat_w, flat_g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
        assert len(flat_w) == len(flat_g)
        for a, b in zip(flat_w, flat_g):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="no first-layer kernel"):
        restore_learner.expand_first_layer(actor, old_d + 1, new_d, False)


def _zero_learner(layout, obs_dim):
    """Parameter dicts of the fused layout's networks at obs_dim (zeros)."""
    packed = layout.pack_params(*_dicts(layout, obs_dim))
    return layout.unpack_params(packed, obs_dim, 2)


def _dicts(layout, obs_dim):
    from space_gym_torch.models import networks

    h = layout.H
    actor = networks.TanhGaussianActor(obs_dim, 2, (h, h)).state_dict()
    critic = networks.DoubleCritic(obs_dim, 2, (h, h)).state_dict()
    return actor, critic, dict(critic), torch.zeros(())


def test_restored_learner_resumes_training(tmp_path, capsys):
    out = str(tmp_path / "kepler.pt")
    small = ["--lanes", "16", "--rollout-len", "4", "--updates-per-iter", "2",
             "--batch-size", "32", "--replay-rows", "16"]
    state = restore_learner.main(["--npz", KEPLER, "--env", "KeplerCircleOrbit-v0", "--out", out,
                                  "--obs-features", "kepler", "--from-obs-dim", "10",
                                  "--device", "cpu", *small])
    assert "expanded learner obs_dim 10 -> 22" in capsys.readouterr().out
    z = np.load(KEPLER)
    # the migrated actor on [obs | any features] acts as the saved one on obs
    layout = fused_sac.build(256)
    old = {k: v.clone() for k, v in layout.unpack_actor(
        torch.as_tensor(z["w"]), torch.as_tensor(z["vec"]), 10).items()}
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    cfg = get_config("KeplerCircleOrbit-v0")
    tr_old = run_agent.make_trainer("sac", EnvEngine(cfg, device="cpu"), (256, 256))
    tr_new = run_agent.make_trainer("sac", EnvEngine(cfg, device="cpu", obs_features="kepler"),
                                    (256, 256))
    obs = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 22)).astype(np.float32))
    torch.testing.assert_close(tr_new.eval_act(state.actor_params, obs),
                               tr_old.eval_act(old, obs[:, :10]), rtol=0, atol=0)
    step = int(z["step"])
    resumed = train.main(["--env", "KeplerCircleOrbit-v0", "--algo", "sac", "--fused",
                          "--obs-features", "kepler", "--ckpt", out, "--resume", "--device", "cpu",
                          "--iters", str(step + 4), "--log-every", "1", "--eval-every", "0",
                          *small])
    text = capsys.readouterr().out
    assert f"resumed from {out} at step {step}" in text
    # the fresh ring of 16 rows fills in four train_iters of 4 rows (the
    # warm-up gate, min(warmup_rows, replay_rows)); the fourth updates K=2 times
    assert resumed.step == step + 4 and resumed.fused.count == int(z["count"]) + 2
