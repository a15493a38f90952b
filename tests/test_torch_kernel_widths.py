"""Which widths and batches the fused trainers take, without a card.

The CUDA learner kernels (K4, K5, K6) are built for hidden widths 128, 256,
384 and 512: wider layers do not fit a thread block's shared memory at a
tile of 32 samples.  A fused trainer on a CUDA device says so when it is
made, not at its first launch; on the CPU every multiple of 128 runs the
plain version.  Any batch, and any number of ring lanes, is cut into the
kernels' tiles, the last of a ring row partial.  The widths the card takes
are held against the JAX kernels' own device VMEM claim.
"""
import numpy as np
import pytest
import torch
from space_gym_tpu.models import fused_sac as jax_fused_sac
from space_gym_tpu.models import fused_td3 as jax_fused_td3

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import SACConfig, SACTrainer, TD3Config, TD3Trainer, learner_kernels

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"
SMALL = dict(lanes=16, rollout_len=4, replay_rows=16, batch_size=20, updates_per_iter=1,
             warmup_rows=4, fused_updates=True)
TRAINERS = {"sac": (SACTrainer, SACConfig), "td3": (TD3Trainer, TD3Config)}


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_fused_trainer_on_a_card_refuses_a_width_not_built(algo, monkeypatch):
    """The constructor raises for H=640 on a CUDA device (its availability
    faked: nothing here touches the card) and takes the built widths."""
    trainer, config = TRAINERS[algo]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = EnvEngine(get_config(ENV))
    assert eng.device.type == "cuda"
    with pytest.raises(ValueError, match=r"built for hidden widths \[128, 256, 384, 512\]"):
        trainer(eng, config(hidden=(640, 640), fused_updates=True))
    with pytest.raises(ValueError, match="shared memory"):
        trainer(eng, config(hidden=(768, 768), fused_updates=True))
    for h in (128, 512):
        assert trainer(eng, config(hidden=(h, h), fused_updates=True)).device.type == "cuda"
    # unfused, any width goes
    trainer(eng, config(hidden=(640, 640)))


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_fused_trainer_on_the_cpu_takes_any_multiple_of_128(algo):
    """H=640 on the CPU: the plain version, with a batch of 20 that no tile
    divides, through the ring route (whole replay rows) and gathered."""
    trainer, config = TRAINERS[algo]
    for lanes in (20, 16):
        tr = trainer(EnvEngine(get_config(ENV), device="cpu"),
                     config(hidden=(640, 640), **dict(SMALL, lanes=lanes)))
        st = tr.init(0)
        st, m = tr.train_iter(st, tr.generator(1))
        assert st.fused.count == 1 and np.isfinite(float(m["critic_loss"]))


def test_tiles_of_a_launch():
    """ceil(lanes / tile) tiles a ring row (or a gathered minibatch)."""
    assert learner_kernels.n_tiles(8192, 0, 64) == 128
    assert learner_kernels.n_tiles(100, 0, 64) == 2
    assert learner_kernels.n_tiles(2048, 4, 64) == 128
    assert learner_kernels.n_tiles(45, 2, 64) == 2
    assert learner_kernels.n_tiles(2039, 4, 64) == 128


VMEM_CLAIM = 64 * 2**20  # vmem_limit_bytes of both JAX kernels (fused_sac.py, fused_td3.py)


def jax_kernel_block_bytes(mod, h):
    """VMEM bytes of the blocks that the JAX fused K-update kernel of
    `build(h)` names in its specs and holds for the whole launch, counted
    once each: the six parameter and moment blocks in, their six aliased
    outputs, and the (GROWS, H) and (VROWS, H) float32 scratch.  Its data
    tile, its activations and any second pipeline buffer come on top."""
    ns = mod.build(h)
    return 4 * h * (3 * ns.WROWS + 3 * ns.VROWS) * 2 + 4 * h * (ns.GROWS + ns.VROWS)


@pytest.mark.parametrize("mod", [jax_fused_sac, jax_fused_td3], ids=["sac", "td3"])
def test_kernel_widths_against_the_jax_kernels_vmem_claim(mod):
    """The card's learner kernels take H in KERNEL_TILE (128-512).  Under its
    64 MiB claim the JAX TD3 kernel's blocks alone fit at those widths and
    no wider (73.7 MiB at H=640).  The JAX SAC kernel's blocks fit at H=640
    too (62.3 MiB), with 1.7 MiB left for its data tile and every
    activation; whether it runs there on its device is not settled by its
    specs."""
    fits = [h for h in range(128, 1024 + 1, 128) if jax_kernel_block_bytes(mod, h) <= VMEM_CLAIM]
    widths = sorted(learner_kernels.KERNEL_TILE)
    mib = {h: round(jax_kernel_block_bytes(mod, h) / 2**20, 1) for h in (512, 640)}
    if mod is jax_fused_td3:
        assert fits == widths
        assert mib == {512: 49.2, 640: 73.7}
    else:
        assert fits == widths + [640]
        assert mib == {512: 41.6, 640: 62.3}
        assert VMEM_CLAIM - jax_kernel_block_bytes(mod, 640) < 2 * 2**20
