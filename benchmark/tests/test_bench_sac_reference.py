"""The frozen SAC update reference against the port's plain version of its
fused kernels, on the CPU at a tiny size: the same leaves, moments and losses
after K updates, with float32 and with bfloat16-rounded products."""
import pytest
import torch

from benchmark.reference import sac_update as ref

H, OD, K, B = 128, 13, 3, 64


def inputs(seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.1):
        return torch.randn(shape, generator=g) * scale

    def w1(*lead):
        w = r(*lead, ref.IN1, H)
        w[..., OD + 2:, :] = 0.0  # the padding rows
        return w

    p = ref.Params(a_w1=w1(), a_b1=r(H), a_w2=r(H, H), a_b2=r(H), a_wh=r(H, 4), a_bh=r(4),
                   c_w1=w1(2), c_b1=r(2, H), c_w2=r(2, H, H), c_b2=r(2, H), c_w3=r(2, H),
                   c_b3=r(2), t_w1=w1(2), t_b1=r(2, H), t_w2=r(2, H, H), t_b2=r(2, H),
                   t_w3=r(2, H), t_b3=r(2), log_alpha=torch.tensor(-2.3))
    batch = ref.Batch(obs=r(K, B, OD, scale=1.0), action=torch.tanh(r(K, B, 2, scale=1.0)),
                      reward=r(K, B, scale=1.0), next_obs=r(K, B, OD, scale=1.0),
                      discount=(torch.rand((K, B), generator=g) > 0.1).float())
    noises = torch.randn((K, B, 2, 2), generator=g)
    return p, batch, noises


@pytest.mark.parametrize("products", ["float32", "bf16"])
def test_reference_follows_the_port(products):
    from space_gym_torch.models import fused_sac
    from space_gym_torch.models.replay import Transition

    fs = fused_sac.build(H)
    p, batch, noises = inputs(3)
    zeros = ref.Params(*[torch.zeros_like(x) for x in p])
    kw = dict(obs_dim=OD, gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)
    got_p, got_m, got_v, count, closs, aloss = ref.update_k(
        p, zeros, zeros, 0, batch, noises, products=products, **kw)
    packed = fs.PackedParams(*[x.clone() for x in p])
    adam = fs.adam_init(packed)
    tr = Transition(obs=batch.obs, action=batch.action, reward=batch.reward,
                    next_obs=batch.next_obs, discount=batch.discount)
    want_p, want_adam, want_c, want_a = fs.update_k_reference(
        packed, adam, tr, noises, mm_bf16=products == "bf16", **kw)
    assert count == want_adam.count == K
    for a, b in zip(got_p + got_m + got_v, want_p + want_adam.m + want_adam.v):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(closs, want_c, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(aloss, want_a, rtol=1e-6, atol=1e-7)


def test_fp8_products_depart():
    """The control's fp8 products move the leaves well away from bf16's."""
    p, batch, noises = inputs(4)
    zeros = ref.Params(*[torch.zeros_like(x) for x in p])
    kw = dict(obs_dim=OD, gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)
    f32 = ref.update_k(p, zeros, zeros, 0, batch, noises, **kw)
    bf = ref.update_k(p, zeros, zeros, 0, batch, noises, products="bf16", **kw)
    f8 = ref.update_k(p, zeros, zeros, 0, batch, noises, products="fp8", **kw)

    def gap(x):
        return float((x[4] - f32[4]).abs().max() / f32[4].abs().max())
    assert gap(f8) > 3 * gap(bf)
