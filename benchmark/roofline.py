"""The yardstick's work counts and the chip's peaks.

A share of a roofline is the least time the chip could take for the work,
the larger of its bytes over the memory bandwidth and its operations over the
arithmetic rate, divided by the time measured.  The work is counted from the
configuration and the traffic, never from an implementation's layout, so no
later layout, fusion or source of random numbers can push a share over 100%.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): HBM3 at
3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in
bf16 on them.  They assume the card's full 700 W power limit.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

MAX_GOAL_CANDIDATES = 3  # a tile's free count lies in 0..3


def int_bytes(largest: int) -> int:
    """The fewest whole bytes that hold the integers 0..largest (or -1..largest)."""
    return max(1, math.ceil(math.log2(largest + 2) / 8))


def goal_tiling(n_planets: int, world_size: float) -> tuple[int, int]:
    """(tiles, columns) of the Goal env's hexagonal tiling
    (hexagonal_tiling.py:161-174)."""
    n_objects = n_planets + 2
    m = n_objects if n_planets == 2 else math.ceil(n_objects / 0.6)
    r = math.ceil(math.sqrt(72 * math.sqrt(3) * m - 6 * math.sqrt(3) + 12) / 12 - 1 / 4
                  + math.sqrt(3) / 12)
    while True:
        c = math.floor(2 * math.sqrt(3) * r / 3 - 1 / 3 + math.sqrt(3) / 3)
        if r * c >= m:
            return r * c, c
        r += 1


def env_step_bytes(env: dict, float_bytes: int = 4) -> int:
    """Bytes one lane's Goal env step must move: each input read once (the
    ship's 6 components, the action's 2, the planets' 2P, the goal's 2, the
    tiling's column shifts and integer rows, the step counter) and each
    output written once (the same state, the observation, the reward, the
    terminated and truncated flags).  Floats at the configured width;
    integers at the fewest bytes that hold their range; no uniforms, since a
    generator inside the step needs none."""
    P = env["n_planets"]
    n_tiles, cols = goal_tiling(P, env["world_size"])
    state_floats = 6 + 2 * P + 2 + cols
    state_ints = (n_tiles * int_bytes(MAX_GOAL_CANDIDATES) + 2 * int_bytes(n_tiles)
                  + int_bytes(env["max_episode_steps"]) + 2)  # + case, flip
    obs_dim = 7 + 2 * P + 2
    reads = (state_floats + 2) * float_bytes + state_ints
    writes = (state_floats + obs_dim + 1) * float_bytes + state_ints + 2
    return reads + writes


def env_step_ops(env: dict, engine: dict, lanes: int, ended: int) -> float:
    """A lower bound of one step's float operations over `lanes` lanes of
    which `ended` ended their episode: only the gravity right-hand sides,
    about 10 + 12 P operations each, 1 + stages per substep of them per lane
    (the last stage is reused), and a lane that ends stops after its first
    substep.  Events, refinement, observation, reward and resets come on top."""
    stages = 6 if engine["tableau"] == "dp5" else 3
    per_rhs = 10 + 12 * env["n_planets"]
    return per_rhs * ((lanes - ended) * (1 + engine["substeps"] * stages)
                      + ended * (1 + stages))


def least_seconds(byts: float, ops: dict) -> float:
    """The least time for `byts` bytes and {"f32": n, "bf16": n} operations."""
    return max(byts / HBM_BYTES_PER_S,
               ops.get("f32", 0) / F32_OPS_PER_S + ops.get("bf16", 0) / BF16_OPS_PER_S)


def env_steps_least_seconds(env: dict, engine: dict, lanes: int, steps: int, ended: int) -> float:
    """The least time of `steps` steps of `lanes` lanes in which `ended`
    episodes ended."""
    byts = env_step_bytes(env) * lanes * steps
    ops = env_step_ops(env, engine, lanes * steps, ended)
    return least_seconds(byts, {"f32": ops})


def sac_work(h, K, B, W, od, bf, lanes):
    """(bytes, {rate: operations}) one fused SAC launch of K updates on
    minibatches of B rows of width W from a ring of `lanes` lanes must move
    and do.  Multiply-adds per sample and update: 16 (1, H) x (H, H)
    products (critic phase 9, actor phase 7); the obs rows of the eleven
    first-layer products, 11 od H; heads, q, their gradients and the action
    gradient, 28 H; and in float32 whatever the mode the action rows of the
    first layers and the dq x w3 products, 20 H.  Two operations per
    multiply-add, about 12 per trainable element and update for Adam and
    polyak.  With bf16 products (`bf`) the products count at the tensor
    cores' rate.  Bytes: each sampled row and the normals read once, the six
    state tensors read and written once, the losses written."""
    dotted = 16 * h * h + 11 * od * h + 28 * h
    plain32 = 20 * h
    trainable = 3 * h * h + 3 * (od + 2) * h + 9 * h + 16
    f32_ops = 2 * plain32 * K * B + 12 * trainable * K
    dot_ops = 2 * dotted * K * B
    ops = {"bf16": dot_ops, "f32": f32_ops} if bf else {"bf16": 0, "f32": f32_ops + dot_ops}
    wrows = 128 + h + 4 * (128 + h) + 8
    byts = 4 * (K * B * W + K * 4 * B + 2 * 3 * (wrows + 16) * h + 2 * K + K * B // lanes)
    return byts, ops


def td3_products(K, n_act):
    """(1, H) x (H, H) products per sample of one fused TD3 launch with
    `n_act` delayed updates: 9 in the critic stage, 2 in the actor stage, 3
    more on a delayed update."""
    return 11 * K + 3 * n_act


def td3_work(h, K, B, W, od, bf, n_act, lanes):
    """(bytes, {rate: operations}) one fused TD3 launch with `n_act` delayed
    updates must move and do: td3_products() H x H products per sample, the
    obs rows of the first layers (9 K + n_act of them), heads, q and head
    gradients (11 K + 6 n_act H), and in float32 the critics' action rows and
    bias sums and dq x w3 (18 K + 2 n_act H); two operations per multiply-add,
    about 10 per critic element for Adam on every update, and on a delayed one
    10 per actor element and 3 per element of both for polyak.  Bytes: each
    sampled row and the normals read once, the six state tensors read and
    written once, the losses written."""
    dotted = (td3_products(K, n_act) * h * h + (9 * K + n_act) * od * h
              + (11 * K + 6 * n_act) * h)
    plain32 = (18 * K + 2 * n_act) * h
    critics = 2 * (h * h + (od + 2) * h + 3 * h + 1)
    actor = h * h + od * h + 4 * h + 2
    f32_ops = 2 * plain32 * B + 10 * critics * K + n_act * (10 * actor + 3 * (actor + critics))
    dot_ops = 2 * dotted * B
    ops = {"bf16": dot_ops, "f32": f32_ops} if bf else {"bf16": 0, "f32": f32_ops + dot_ops}
    wrows = 6 * (128 + h) + 8
    byts = 4 * (K * B * W + K * 2 * B + 2 * 3 * (wrows + 24) * h + 2 * K + K * B // lanes)
    return byts, ops
