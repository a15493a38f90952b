"""The yardstick's work counts against hand-worked cases."""
import json
import os

import pytest

from benchmark import roofline

from .conftest import BENCH


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name, tiles, cols, byts, rhs_ops", [
    # 2P: 4 tiles in 2 columns.  State floats 6 + 4 + 2 + 2 = 14, integer
    # bytes 4 free counts + 2 tiles + 2 (steps to 500) + case + flip = 10,
    # obs 13.  Reads (14 + 2 action) * 4 + 10 = 74; writes (14 + 13 + 1) * 4
    # + 10 + 2 flags = 124.  Gravity rhs 10 + 12 * 2 = 34 ops, 1 + 2 * 6 a lane.
    ("goal2p", 4, 2, 198, 34 * 13),
    # 4P: 16 tiles in 4 columns.  Floats 6 + 8 + 2 + 4 = 20, integer bytes
    # 16 + 2 + 2 + 2 = 22, obs 17.  Reads 22 * 4 + 22 = 110; writes 38 * 4
    # + 22 + 2 = 176.  Rhs 10 + 48 = 58 ops.
    ("goal4p", 16, 4, 286, 58 * 13),
])
def test_env_step_work(name, tiles, cols, byts, rhs_ops):
    c = config(name)
    env, eng = c["env"], c["engine"]
    assert roofline.goal_tiling(env["n_planets"], env["world_size"]) == (tiles, cols)
    assert roofline.env_step_bytes(env) == byts
    assert roofline.env_step_ops(env, eng, 1, 0) == rhs_ops
    # a lane that ends stops after its first substep: 1 + 6 evaluations
    assert roofline.env_step_ops(env, eng, 1, 1) == rhs_ops // 13 * 7
    want = byts * 1000 * 3 / roofline.HBM_BYTES_PER_S
    assert roofline.env_steps_least_seconds(env, eng, 1000, 3, 0) == pytest.approx(want)


@pytest.mark.parametrize("uniforms", ["bulk", "threefry", "philox"])
def test_count_ignores_the_uniform_source(uniforms):
    """The work is the step's, not a layout's: where its uniforms come from
    does not change it."""
    c = config("goal4p")
    eng = dict(c["engine"], uniforms=uniforms)
    assert roofline.env_steps_least_seconds(c["env"], eng, 262144, 256, 100) == \
        roofline.env_steps_least_seconds(c["env"], c["engine"], 262144, 256, 100)


def test_int_bytes():
    assert [roofline.int_bytes(n) for n in (1, 3, 16, 254, 255, 500, 65534)] == [1, 1, 1, 1, 2, 2, 2]


def test_learner_work_by_hand():
    """One SAC update of one sample, h=128, od=13, W=33, from a ring of one
    lane, float32 products: 2 * (16 h^2 + 11 od h + 48 h) operations for the
    sample and 12 per trainable element."""
    h, od = 128, 13
    trainable = 3 * h * h + 3 * (od + 2) * h + 9 * h + 16
    byts, ops = roofline.sac_work(h, 1, 1, 33, od, False, 1)
    assert ops == {"bf16": 0, "f32": 2 * (16 * h * h + 11 * od * h + 48 * h) + 12 * trainable}
    assert byts == 4 * (33 + 4 + 6 * (128 + h + 4 * (128 + h) + 8 + 16) * h + 2 + 1)
    byts_bf, ops_bf = roofline.sac_work(h, 1, 1, 33, od, True, 1)
    assert byts_bf == byts and ops_bf["bf16"] + ops_bf["f32"] == ops["f32"]
    assert roofline.td3_products(4, 2) == 50
    _, td3 = roofline.td3_work(h, 1, 1, 33, od, False, 0, 1)
    critics = 2 * (h * h + (od + 2) * h + 3 * h + 1)
    assert td3["f32"] == 2 * (11 * h * h + 9 * od * h + 11 * h) + 2 * 18 * h + 10 * critics
    t = roofline.least_seconds(1e9, {"f32": 67e12, "bf16": 989e12})
    assert t == pytest.approx(2.0)
