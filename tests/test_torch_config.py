"""The port's static configuration (space_gym_torch) against space_gym_tpu:
registry, EnvConfig fields, hex-tiling geometry, tableaux, constants, and
the uniform-row count of the full-step kernel.  All exact equality."""
import dataclasses

import pytest

import space_gym_tpu
from space_gym_tpu.ops import rk45 as jrk45
from space_gym_tpu.ops.pallas_full import make_full_step
from space_gym_tpu.tiling import geometry as jgeom

import space_gym_torch
from space_gym_torch.envs import config as tconfig
from space_gym_torch.ops import constants as tconst
from space_gym_torch.ops import field as tfield
from space_gym_torch.ops import rk45 as trk45
from space_gym_torch.ops.full_step_plain import count_uniform_rows, int_rows
from space_gym_torch.tiling import geometry as tgeom

ENV_IDS = space_gym_tpu.env_ids()


def test_registry_ids_match():
    assert space_gym_torch.env_ids() == ENV_IDS
    with pytest.raises(KeyError):
        space_gym_torch.get_config("NoSuchEnv-v0")


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_config_fields_match(env_id):
    got = space_gym_torch.get_config(env_id)
    want = space_gym_tpu.get_config(env_id)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.obs_dim == want.obs_dim
    assert got.n_events == want.n_events
    assert got.observation_bounds() == want.observation_bounds()


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_uniform_rows_match_full_kernel(env_id):
    jfull = make_full_step(space_gym_tpu.get_config(env_id), 1, 8, block=128, interpret=True,
                           tableau="bs3")
    cfg = space_gym_torch.get_config(env_id)
    assert count_uniform_rows(cfg) == jfull.n_uniform_rows
    assert int_rows(cfg) == jfull.n_int_rows


@pytest.mark.parametrize("n_planets", [2, 3, 4, 5])
@pytest.mark.parametrize("world_size", [3.0, 2.0])
def test_tiling_geometry_matches(n_planets, world_size):
    assert tgeom.make_tiling(n_planets, world_size) == jgeom.make_tiling(n_planets, world_size)


def test_constants_and_tables_match():
    from space_gym_tpu.envs import config as jconfig
    from space_gym_tpu.ops import constants as jconst
    from space_gym_tpu.ops import field as jfield

    assert tconst.G == jconst.G
    assert tgeom.DIAGONAL_CASES == jgeom.DIAGONAL_CASES
    assert tgeom.MAX_GOAL_CANDIDATES == jgeom.MAX_GOAL_CANDIDATES
    assert tconfig.DISCRETE_ACTIONS == jconfig.DISCRETE_ACTIONS
    assert tconfig.NO_TIME_LIMIT == jconfig.NO_TIME_LIMIT
    for name in ("TASK_GOAL", "TASK_KEPLER", "TASK_DO_NOT_CRASH"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    for name in ("STEERING_ACCELERATION", "STEERING_VELOCITY", "VELOCITY_STEERING_SCALE"):
        assert getattr(tfield, name) == getattr(jfield, name)
    assert tfield.ShipParams._fields == jfield.ShipParams._fields
    for name in ("DP_A", "DP_B", "DP_P", "N_STAGES", "BS3_A", "BS3_B", "BS3_P", "BS3_N_STAGES"):
        assert getattr(trk45, name) == getattr(jrk45, name), name
