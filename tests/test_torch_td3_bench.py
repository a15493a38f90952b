"""The goal2p-td3 cell's pieces on the CPU at a tiny size, and on the card at
its full size.

  * benchmark/reference/td3_update.py, the frozen plain TD3 reference that
    decides the cell's `correct`, against the port's TD3 on seeded random
    weights (H 128, B 64, K 4, policy delay 2, so a launch holds delayed and
    critic-only updates): the plain version of K6 (`fused_update_k_wmat`
    and `fused_update_k_wmat_batches` on CPU tensors) in float32 and with
    bfloat16 products, and the unfused `TD3Trainer._update_once`;
  * a tiny goal2p-td3 run through `benchmark.harness.run`: it is correct,
    and each of benchmark/faults_td3.py's faults and the float8 control are
    not;
  * the program's counts `td3.critic_updates` and `td3.actor_updates`
    against K and `applied_steps`, and against the benchmark's own count.

This file imports no JAX: the card test runs in it too.

    python3 -m pytest tests/test_torch_td3_bench.py -q -p no:cacheprovider
"""
import ast
import io
import json
import os
import shutil
import sys
import types

import pytest
import torch

from benchmark import faults_td3, harness
from benchmark.modes import td3 as td3_mode
from benchmark.reference import td3_update as ref
from benchmark.registry import Registry

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import TD3Config, TD3Trainer, fused_td3
from space_gym_torch.models.replay import Transition, pack_slab
from space_gym_torch.utils import profiling

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, OD, K, B = 128, 13, 4, 64
HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, smooth_std=0.2, smooth_clip=0.5, policy_delay=2)
# the warm-up gate at min(32, replay_rows) = 8 rows: the first call's rollout
# fills half of it, the second passes it
TINY_TD3 = {"lanes": 32, "rollout_len": 4, "batch_size": 64, "updates_per_iter": 2,
            "replay_rows": 8, "hidden": 128, "warmup_calls": 1, "fused_block": 64}
# On the CPU the K-update is the reference's own arithmetic (equal bits, the
# first test), so the tiny cell's learner numbers read the env's float32 rows
# against the reference's float64 ones alone, under 1e-5; the card's bf16
# kernel reads up to a few thousandths, which the cell's limits allow.  The
# tiny cell is held to a hundredth of those limits, under which the smoothing
# fault (2e-3 and more here, a few thousandths on the card at the start)
# shows as the others do.
CPU_SCALED = ("loss_gap", "grad_gap", "change_gap", "end_loss_gap", "end_change_gap")


def inputs(seed):
    """Seeded random leaves (zero padding rows; targets drawn apart from the
    online networks, so that a mix-up of the two shows), K minibatches and
    smoothing normals."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.1):
        return torch.randn(shape, generator=g) * scale

    def w1(*lead, rows):
        w = r(*lead, ref.IN1, H)
        w[..., rows:, :] = 0.0
        return w

    def actor():
        return [w1(rows=OD), r(H), r(H, H), r(H), r(H, 2), r(2)]

    def critic():
        return [w1(2, rows=OD + 2), r(2, H), r(2, H, H), r(2, H), r(2, H), r(2)]

    p = ref.Params(*actor(), *actor(), *critic(), *critic())
    batch = ref.Batch(obs=r(K, B, OD, scale=1.0), action=torch.tanh(r(K, B, 2, scale=1.0)),
                      reward=r(K, B, scale=1.0), next_obs=r(K, B, OD, scale=1.0),
                      discount=(torch.rand((K, B), generator=g) > 0.1).float())
    return p, batch, torch.randn((K, B, 2), generator=g)


def zeros_like(p):
    return ref.Params(*[torch.zeros_like(x) for x in p])


@pytest.mark.parametrize("entry", ["ring", "batches"])
@pytest.mark.parametrize("count", [0, 3], ids=["from-even", "from-odd"])
@pytest.mark.parametrize("products", ["float32", "bf16"])
def test_reference_follows_the_fused_plain_version(products, count, entry):
    """The same operations in the same order as the plain version of K6
    (fused_td3.update_k_reference): equal bits, leaves, both moments, both
    Adam counts and losses, from a count before a delayed update and from
    one before a critic-only update; through the trainer's entry point,
    which samples rows of a ring (here K rows of B lanes, one a minibatch),
    and through the one of gathered minibatches."""
    ft = fused_td3.build(H)
    p, batch, noises = inputs(3)
    count_a = (count + 1) // 2
    want = ref.update_k(p, zeros_like(p), zeros_like(p), count, count_a, batch, noises,
                        obs_dim=OD, products=products, **HYPER)
    f = ft.fused_init(ft.PackedParams(*[x.clone() for x in p]),
                      ft.adam_init(ft.PackedParams(*p))._replace(count=count, count_a=count_a))
    kw = dict(obs_dim=OD, block=B, mm_bf16=products == "bf16", **HYPER)
    if entry == "ring":
        ring = pack_slab(Transition(*batch), OD, 2)
        f, closs, aloss = ft.fused_update_k_wmat(f, ring, torch.arange(K), noises, **kw)
    else:
        f, closs, aloss = ft.fused_update_k_wmat_batches(f, Transition(*batch), noises, **kw)
    packed, adam = ft.fused_unpack(f)
    assert (adam.count, adam.count_a) == (want[3], want[4]) == (count + K, count_a + 2)
    for name, got, w in zip(ref.Params._fields * 3, list(packed) + list(adam.m) + list(adam.v),
                            list(want[0]) + list(want[1]) + list(want[2])):
        assert torch.equal(got, w), name
    assert torch.equal(closs, want[5]) and torch.equal(aloss, want[6])


def test_reference_follows_update_once():
    """The unfused trainer's K updates, one `_update_once` each on the same
    minibatch and normals.  Tolerances of tests/test_torch_fused_td3.py
    (float32 sums in another order, here the critics' concatenated input
    against the reference's split first layer and Adam's bias corrections in
    float64 against float32 exp, through Adam's division by sqrt(v)):
    leaves rtol 2e-4 / atol 2e-5, moments rtol 2e-3 / atol 2e-5, critic
    loss rtol 1e-4, actor loss rtol 1e-3; the counts exact."""
    p, batch, noises = inputs(5)
    want = ref.update_k(p, zeros_like(p), zeros_like(p), 0, 0, batch, noises, obs_dim=OD,
                        **HYPER)
    tr = TD3Trainer(EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu"),
                    TD3Config(lanes=8, hidden=(H, H), **HYPER))
    ft = tr._need_layout()
    trees = [{k: v.clone() for k, v in t.items()}
             for t in ft.unpack_params(ft.PackedParams(*p), OD)]
    st = tr.init(0)._replace(actor_params=trees[0], target_actor_params=trees[1],
                             critic_params=trees[2], target_critic_params=trees[3])
    closs, aloss = [], []
    for k in range(K):
        st, m = tr._update_once(st, batch=Transition(*[x[k] for x in batch]), noise=noises[k])
        closs.append(m["critic_loss"])
        aloss.append(m["actor_loss"])
    packed, adam = ft.fused_unpack(tr.migrate_to_fused(st).fused)
    assert (adam.count, adam.count_a, st.n_updates) == (want[3], want[4], K) == (K, 2, K)
    torch.testing.assert_close(torch.stack(closs), want[5], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(torch.stack(aloss), want[6], rtol=1e-3, atol=1e-5)
    for name, got, w in zip(ref.Params._fields, packed, want[0]):
        torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-5, msg=name)
    for name, got, w in zip(ref.Params._fields, adam.m, want[1]):
        torch.testing.assert_close(got, w, rtol=2e-3, atol=2e-5, msg=name)


def test_reference_imports_neither_jax_nor_the_port():
    with open(ref.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    tops = {n.split(".")[0] for n in names if n}
    assert tops <= {"__future__", "typing", "torch", "sac_update"}, tops
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("first", [0, 1, 2, 5])
def test_update_counts_follow_applied_steps(first):
    """Each launch of the plain version, from odd and even counts, adds K to
    `td3.critic_updates` and its delayed updates to `td3.actor_updates`: the
    program's applied_steps, and the benchmark's own count alike."""
    ft = fused_td3.build(H)
    p, batch, noises = inputs(7)
    f = ft.fused_init(ft.PackedParams(*p), ft.adam_init(ft.PackedParams(*p))._replace(
        count=first, count_a=(first + 1) // 2))
    for k in (1, 2, 3):  # K of 1, 2 and 3 updates: the parity moves between launches
        before = profiling.counts()
        n, n_a = int(f.count), int(f.count_a)
        f, _, _ = ft.fused_update_k_wmat_batches(
            f, Transition(*[x[:k] for x in batch]), noises[:k].contiguous(), obs_dim=OD,
            block=B, mm_bf16=False, **HYPER)
        got = {key: profiling.counts().get(key, 0) - before.get(key, 0)
               for key in ("td3.critic_updates", "td3.actor_updates", "td3_update")}
        acted = fused_td3.applied_steps(n, k, 2)
        assert acted == td3_mode.delayed_updates(n, k, 2)
        assert got == {"td3.critic_updates": k, "td3.actor_updates": acted, "td3_update": 0}
        assert (int(f.count), int(f.count_a)) == (n + k, n_a + acted)
    assert int(f.count_a) == (first + 1) // 2 + td3_mode.delayed_updates(first, 6, 2)


def test_counts_check_reads_each_call_and_skips_a_program_without_counters():
    live = [False, True, True]
    good = [(0, 0), (4, 2), (8, 4)]
    assert td3_mode.counts_off((0, 0), good, live, 4, 2) == 0
    # call by call: 2 actor updates too many in the second, 2 too few in the third
    assert td3_mode.counts_off((0, 0), [(0, 0), (4, 4), (8, 4)], live, 4, 2) == 4
    # the updates of the second made in the first, before the gate
    assert td3_mode.counts_off((0, 0), [(4, 2), (4, 2), (8, 4)], live, 4, 2) == 12
    # counts first kept by the second call's updates read 0 before
    assert td3_mode.counts_off((None, None), [(None, None)] + good[1:], live, 4, 2) == 0
    # a program that counts no updates: no reading
    assert td3_mode.counts_off((None, None), [(None, None)] * 3, live, 4, 2) is None


# ---------------------------------------------------------------- the cell --
@pytest.fixture
def td3_bench(tmp_path):
    """A copy of benchmark/ (without its tests) with `tiny_td3`, a small TD3
    job, `goal2p_td3_tiny`, goal2p_td3's learner at the job's width, and the
    cell `goal2p-td3-tiny` on them, its learner numbers held to a hundredth
    of goal2p-td3's limits (CPU_SCALED)."""
    root = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((root / "traffic" / "td3_documented.json").read_text())
    (root / "traffic" / "tiny_td3.json").write_text(json.dumps(dict(traffic, **TINY_TD3)))
    w = json.loads((root / "workloads" / "goal2p-td3.json").read_text())
    cfg = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    learner = dict(cfg["learner"], hidden=[TINY_TD3["hidden"]] * len(cfg["learner"]["hidden"]))
    (root / "configs" / "goal2p_td3_tiny.json").write_text(
        json.dumps(dict(cfg, name="goal2p_td3_tiny", learner=learner)))
    limits = {k: v / 100 if k in CPU_SCALED else v for k, v in w["limits"].items()}
    (root / "workloads" / "goal2p-td3-tiny.json").write_text(
        json.dumps(dict(w, config="goal2p_td3_tiny", traffic="tiny_td3", limits=limits)))
    return Registry(str(root))


@pytest.fixture
def own_process(monkeypatch):
    """sys.modules as a run's own process has them: without the JAX modules
    that the suite's other files loaded into this one, so that the harness's
    check of loaded modules sees what the run itself loads."""
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)


def run_cell(reg, seed=2**31 + 17):
    out = io.StringIO()
    args = types.SimpleNamespace(workload="goal2p-td3-tiny", seed=seed, seconds=0.2, trace=0)
    rc = harness.run(args, 0.0, device=torch.device("cpu"), reg=reg, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_tiny_td3_cell_is_correct(td3_bench, own_process):
    rc, res = run_cell(td3_bench)
    assert rc == 0 and res["correct"] is True, res
    assert set(res["metrics"]) == {"setup_s", "train_env_steps_per_s"}
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap", "end_lanes_off_pct",
                                  "end_loss_gap", "end_change_gap", "update_counts_off"}
    assert res["checks"]["update_counts_off"]["value"] == 0


@pytest.mark.parametrize("kind", faults_td3.KINDS)
def test_td3_faults_are_not_correct(td3_bench, own_process, kind):
    with faults_td3.plant(f"td3.{kind}"):
        rc, res = run_cell(td3_bench)
    assert rc == 0 and res["correct"] is False, res
    assert "_fused_minibatches" not in vars(TD3Trainer)
    assert "_update_fused" in vars(TD3Trainer)  # its own method is back


def test_td3_control_is_not_correct(td3_bench):
    w = td3_bench.workload("goal2p-td3-tiny")
    mode = harness.load_mode(td3_bench, "td3").Mode(
        td3_bench.config("goal2p_td3_tiny"), td3_bench.traffic("tiny_td3"), 3, torch.device("cpu"))
    mode.setup()
    got = mode.check(control=True)
    assert all(v <= w["limits"][k] for k, v in got["program"].items()), got
    assert any(v > w["limits"][k] for k, v in got["control"].items()), got



@pytest.mark.parametrize("key,value", [("algorithm", "sac"), ("actor", "gaussian"),
                                       ("hidden", [256, 256]), ("obs_dim", 12), ("act_dim", 3),
                                       ("critics", 1)])
def test_td3_mode_holds_the_trainer_to_the_learner(td3_bench, key, value):
    """A configuration whose learner the trainer does not build is refused
    before any call."""
    cfg = td3_bench.config("goal2p_td3_tiny")
    cfg = dict(cfg, learner=dict(cfg["learner"], **{key: value}))
    mode = harness.load_mode(td3_bench, "td3").Mode(
        cfg, td3_bench.traffic("tiny_td3"), 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="learner|configuration"):
        mode.setup()
    assert mode.counted == []

# ---------------------------------------------------------------- the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_goal2p_td3_mode_at_full_size(cuda_device):
    """goal2p-td3's mode on the card at its full size: the checked calls of
    set-up, two calls under the profiler, each launching K6 once, the
    counters, and a check within the cell's limits."""
    from benchmark.trace import traced_window

    reg = Registry()
    w = reg.workload("goal2p-td3")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = harness.load_mode(reg, "td3").Mode(reg.config(w["config"]), reg.traffic(w["traffic"]),
                                              2**31 + 23, cuda_device)
    mode.setup()
    before = td3_mode.program_counts()
    trace = traced_window(mode, 2)
    assert trace["hits"] == 2, trace["kernels"]
    after = td3_mode.program_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (64, 32)
    got = mode.check()
    assert got["update_counts_off"] == 0
    assert all(v <= w["limits"][k] for k, v in got.items()), got
