"""The port's adapters (space_gym_torch/compat/, `make`, `make_gymnasium`,
`VectorEnv`) and renderer against the JAX package's tests of the same
surface and its recorded goldens, all on the CPU.

- physics="host": full episodes bit for bit against the goldens
  (tests/test_golden_parity.py::test_full_episode_bitwise_host_physics);
- physics="device": the single-step tier at atol 1e-10 for all 7 ids
  (tests/test_golden_parity.py::test_single_step_device_physics);
- spaces, registry, Gymnasium facade, VectorEnv, vector_field and the
  renderer's golden frame (tests/test_spaces.py, tests/test_aux.py).
"""
import math
import os

import numpy as np
import pytest
import torch

import space_gym_torch
from space_gym_torch.compat import options

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_IDS = ["GoalContinuous2P-v0", "GoalContinuous3P-v0", "GoalContinuous4P-v0",
              "KeplerCircleOrbit-v0", "KeplerEllipseEasy-v0", "KeplerEllipseHard-v0",
              "KeplerRandomOrbits-v0"]


def load(env_id, subset=""):
    return np.load(os.path.join(GOLDEN_DIR, subset, f"{env_id}.npz"))


def make(env_id, **kw):
    return space_gym_torch.make(env_id, device="cpu", **kw)


@pytest.mark.parametrize("subset", ["", "seed7"])
@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerEllipseHard-v0"])
def test_full_episode_bitwise_host_physics(env_id, subset):
    g = load(env_id, subset)
    seed = int(g["seed"])
    env = make(env_id, physics="host")
    for ep in range(int(g["episodes"])):
        p = f"ep{ep}_"
        np.random.seed(seed + 1000 * ep)
        env.seed(seed + ep)
        obs = env.reset()
        np.testing.assert_array_equal(obs, g[p + "reset_obs"], err_msg=f"{env_id} ep{ep} reset")
        np.testing.assert_array_equal(env._state_vec, g[p + "reset_state"])
        np.testing.assert_array_equal(env.planets_pos, g[p + "reset_planets"])
        if env.goal_pos is not None:
            np.testing.assert_array_equal(env.goal_pos, g[p + "reset_goal"])
        for t, action in enumerate(g[p + "actions"]):
            obs, reward, done, info = env.step(action)
            msg = f"{env_id} ep{ep} step {t}"
            np.testing.assert_array_equal(env._state_vec, g[p + "post_states"][t], err_msg=msg)
            np.testing.assert_array_equal(obs, g[p + "obs"][t], err_msg=msg)
            assert reward == g[p + "rewards"][t], msg
            assert done == bool(g[p + "dones"][t]), msg
            assert info.get("TimeLimit.truncated", False) == bool(g[p + "truncated"][t]), msg
        assert done


@pytest.mark.parametrize("env_id", GOLDEN_IDS)
def test_single_step_device_physics(env_id):
    """The first recorded episode, each step from its recorded pre-step
    state through the device physics (ops/rk45.py::solve_step, float64)."""
    g = load(env_id)
    seed = int(g["seed"])
    env = make(env_id)  # physics="device", the default
    assert env.device.type == "cpu"
    p = "ep0_"
    np.random.seed(seed)
    env.seed(seed)
    env.reset()
    env.planets_pos = g[p + "reset_planets"]
    if env.config.kepler is not None and p + "orbit" in g:
        env.ref_orbit_angle, env.ref_orbit_eccentricity, env.ref_orbit_a = g[p + "orbit"][0][:3]
    max_state = 0.0
    for t, action in enumerate(g[p + "actions"]):
        env._state_vec = g[p + "pre_states"][t].copy()
        env.goal_pos = (g[p + "reset_goal"] if t == 0 else g[p + "goals"][t - 1]).copy()
        env._elapsed_steps = 0
        obs, reward, done, _ = env.step(action)
        msg = f"{env_id} step {t}"
        assert done == (bool(g[p + "dones"][t]) and not bool(g[p + "truncated"][t])), msg
        np.testing.assert_allclose(env._state_vec, g[p + "post_states"][t], rtol=0, atol=1e-10,
                                   err_msg=msg)
        np.testing.assert_allclose(obs, g[p + "obs"][t], rtol=0, atol=1e-9, err_msg=msg)
        np.testing.assert_allclose(reward, g[p + "rewards"][t], rtol=1e-7, atol=1e-7, err_msg=msg)
        max_state = max(max_state, np.max(np.abs(env._state_vec - g[p + "post_states"][t])))
    assert max_state < 1e-10


def test_spaces_and_registry():
    """tests/test_spaces.py and tests/test_aux.py::test_registry_lists_all_upstream_ids."""
    env = make("GoalContinuous3P-v0", physics="host")
    low, high = env.observation_space.low, env.observation_space.high
    assert env.observation_space.shape == (15,)
    np.testing.assert_allclose(high[:4], 1.0)
    assert np.isinf(high[4]) and np.isinf(high[5]) and high[6] == 1.0
    np.testing.assert_allclose(high[7:], 2 * math.sqrt(2), rtol=1e-6)
    np.testing.assert_allclose(low, -high)
    kep = make("KeplerEllipseEasy-v0", physics="host").observation_space
    assert kep.shape == (10,)  # quirk Q7: symmetric, orbit bounds after the base 7
    np.testing.assert_allclose(kep.high[7:], [2 * math.pi, 0.7, 2.0], rtol=1e-6)
    np.testing.assert_allclose(kep.low, -kep.high)
    for env_id in ("GoalDiscrete3-v0", "KeplerDiscrete-v0"):
        space = make(env_id).action_space
        assert space.n == 6 and space.contains(0) and space.contains(5)
        assert not space.contains(6)
    box = make("GoalContinuous2P-v0").action_space
    a = box.sample()
    assert a.shape == (2,) and a.dtype == np.float32
    assert box.contains(np.array([1.0, -1.0], np.float32))
    assert not box.contains(np.array([1.5, 0.0], np.float32))
    ids = space_gym_torch.env_ids()
    for required in ["DoNotCrashDiscrete-v0", "DoNotCrashContinuous-v0", "GoalDiscrete-v0",
                     *GOLDEN_IDS]:
        assert required in ids, required
    with pytest.raises(KeyError):
        space_gym_torch.get_config("NopeEnv-v0")


def test_gymnasium_adapter_in_lockstep_with_the_old_api():
    """tests/test_aux.py::test_gymnasium_adapter_new_api."""
    env = space_gym_torch.make_gymnasium("GoalContinuous2P-v0", physics="host")
    obs, info = env.reset(seed=42)
    assert isinstance(info, dict) and obs.shape == (13,)
    obs2, _ = env.reset(seed=42)
    np.testing.assert_array_equal(obs, obs2)
    old = make("GoalContinuous2P-v0", physics="host")
    old.seed(42)
    np.testing.assert_array_equal(obs2, old.reset())
    rng = np.random.RandomState(0)
    terminated = truncated = False
    for _ in range(600):
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        obs_n, r_n, terminated, truncated, info_n = env.step(a)
        obs_o, r_o, done_o, info_o = old.step(a)
        assert r_n == r_o and (terminated or truncated) == done_o
        np.testing.assert_array_equal(obs_n, obs_o)
        assert "TimeLimit.truncated" not in info_n
        if terminated or truncated:
            assert truncated == bool(info_o.get("TimeLimit.truncated", False))
            break
    assert terminated or truncated
    assert env.planets_pos.shape == (2, 2) and env.goal_pos.shape == (2,)
    assert env.unwrapped.config.env_id == "GoalContinuous2P-v0"
    env.close()
    old.close()


def test_vector_env_contract():
    """tests/test_aux.py::test_vector_env_contract and _discrete."""
    venv = space_gym_torch.VectorEnv("GoalContinuous2P-v0", num_envs=16, seed=0, device="cpu")
    assert venv.engine.tier == "fixed" and venv.engine.substeps == 2
    obs = venv.reset()
    assert obs.shape == (16, venv.config.obs_dim) and obs.dtype == np.float32
    rng = np.random.default_rng(0)
    ended = 0
    for _ in range(5):
        obs, rewards, dones, infos = venv.step(rng.uniform(-1, 1, (16, 2)).astype(np.float32))
        assert obs.shape == (16, venv.config.obs_dim)
        assert rewards.shape == (16,) and dones.shape == (16,) and len(infos) == 16
        for i, info in enumerate(infos):
            if dones[i]:
                assert info["terminal_observation"].shape == (venv.config.obs_dim,)
                ended += 1
            else:
                assert info == {}
    venv.seed(3)
    a = venv.reset()
    venv.seed(3)
    np.testing.assert_array_equal(a, venv.reset())
    dnc = space_gym_torch.VectorEnv("DoNotCrashDiscrete-v0", num_envs=8, seed=1, device="cpu")
    dnc.reset()
    _, rewards, _, _ = dnc.step(rng.integers(0, 6, size=8))
    np.testing.assert_allclose(rewards, 100.0 / 300.0, rtol=1e-6)


def test_vector_env_truncation_infos_and_option_names():
    """Every lane truncates at a cap of 2 steps: `infos` carries the terminal
    observation and TimeLimit.truncated.  The JAX package's option names
    reach the engine in the port's spelling; auto_reset=False with the
    full-step kernel is refused (ROADMAP §3)."""
    import dataclasses

    cfg = dataclasses.replace(space_gym_torch.get_config("KeplerCircleOrbit-v0"),
                              max_episode_steps=2)
    venv = space_gym_torch.VectorEnv(cfg, num_envs=4, device="cpu", physics="pallas",
                                     pallas_fuse="physics", pallas_tableau="bs3", substeps=1)
    assert (venv.engine.tier, venv.engine.tableau) == ("physics", "bs3")
    venv.reset()
    zeros = np.zeros((4, 2), np.float32)
    venv.step(zeros)
    obs, _, dones, infos = venv.step(zeros)
    assert dones.all()
    for i, info in enumerate(infos):
        assert info["TimeLimit.truncated"] is True
        assert not np.array_equal(info["terminal_observation"], obs[i])
    assert options.engine_options(physics="pallas", in_kernel_rng="hw", pallas_fuse="full") == {
        "physics": "kernel", "in_kernel_rng": "philox", "fuse": "full"}
    assert options.engine_options(physics="adaptive", auto_reset=False) == {
        "physics": "adaptive", "auto_reset": False}
    for bad in (dict(auto_reset=False), dict(physics="pallas", auto_reset=False),
                dict(physics="kernel", pallas_fuse="full", auto_reset=False)):
        with pytest.raises(ValueError, match="tail tier"):
            options.engine_options(**bad)
    with pytest.raises(TypeError):
        options.engine_options(fuse="env", pallas_fuse="env")
    assert options.adapter_physics("jax") == "device"
    assert make("DoNotCrashContinuous-v0", physics="jax")._physics_mode == "device"


def test_vector_field_and_physics_modes():
    """tests/test_aux.py::test_gym_adapter_spaces_and_vector_field; the
    native C++ mode builds, or raises its build error (tests/test_torch_native.py
    holds its bits)."""
    env = make("KeplerEllipseHard-v0", physics="host")
    assert env.observation_space.shape == (10,) and env.action_space.shape == (2,)
    env.seed(0)
    env.reset()
    deriv = env.vector_field(np.array([0.0, 0.0], np.float32))
    assert deriv.shape == (6,)
    np.testing.assert_allclose(deriv[:2], env._state_vec[3:5])
    from space_gym_torch.parity import native

    if native.is_available():
        assert make("GoalContinuous2P-v0", physics="native")._physics_mode == "native"
    else:
        with pytest.raises(RuntimeError, match="native solver unavailable"):
            make("GoalContinuous2P-v0", physics="native")
    with pytest.raises(ValueError):
        make("GoalContinuous2P-v0", physics="pallas")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert space_gym_torch.make("GoalContinuous2P-v0").device.type == "cuda"
        venv = space_gym_torch.VectorEnv("GoalContinuous2P-v0", num_envs=4)
        assert venv.engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        space_gym_torch.make("GoalContinuous2P-v0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        space_gym_torch.make_gymnasium("GoalContinuous2P-v0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        space_gym_torch.VectorEnv("GoalContinuous2P-v0", num_envs=4)


def test_renderer_golden_image():
    """tests/test_aux.py::test_renderer_golden_image, at its tolerance."""
    from PIL import Image

    env = make("GoalContinuous2P-v0", physics="host")
    env.seed(42)
    env.reset()
    for _ in range(5):
        env.step(np.array([0.8, -0.3], np.float32))
    frame = env.render(mode="rgb_array").astype(np.int16)
    env.reset()
    assert env.render(mode="rgb_array").shape == (600, 600, 3)
    env.close()
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, "render_goal2p_seed42_step5.png")),
                        np.int16)
    assert frame.shape == golden.shape
    mismatched = (np.abs(frame - golden) > 8).any(-1)
    assert mismatched.mean() < 0.002, f"{mismatched.sum()} pixels differ beyond tolerance"
