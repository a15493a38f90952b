"""The two in-kernel random sources: their plain versions
(space_gym_torch/ops/rng_plain.py) and the engines that draw with them.

* threefry: bit for bit `jax.random.uniform`, also for a batch that is no
  multiple of 128; the CPU engine with `in_kernel_rng="threefry"` and the key
  words equals the engine fed the JAX-drawn matrix, bit for bit, through
  forced resets of every lane (counterpart of
  tests/test_pallas_full.py::test_in_kernel_rng_bitwise_vs_xla_draw);
* Philox4x32-10: the known-answer vectors of the Random123 distribution
  (kat_vectors: zero, all-ones and pi-digit counters and keys; PyTorch's own
  engine, ATen/core/PhiloxRNGEngine.h, gives the same words), range, moments
  and a KS test against the uniform law, distinct streams per lane; reset
  marginals of the "philox" engine against the JAX fixed tier's by KS,
  p > 1e-3, B=512 (counterpart of test_full_reset_distribution_matches_xla).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.stats import ks_2samp, kstest

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.ops import rng_plain
from space_gym_torch.ops.full_step import FullStep

from .torch_scenarios import one_torch_thread, scenario_inputs  # noqa: F401 (autouse)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


@pytest.mark.parametrize("batch,n_rows,seed", [(512, 7, 123), (100, 50, 7), (3, 138, 2**31 + 5)])
def test_plain_threefry_matches_jax_uniform_bitwise(batch, n_rows, seed):
    key = jax.random.key(seed)
    words = np.asarray(jax.random.key_data(key))
    want = np.asarray(jax.random.uniform(key, (batch, n_rows), jnp.float32)).T
    got = rng_plain.threefry_uniform_matrix(rng_plain.key_words(words), batch, n_rows).numpy()
    assert got.shape == (n_rows, batch) and got.dtype == np.float32
    assert (_bits(got) == _bits(want)).all()


def test_key_words_take_every_integer_form():
    words = np.array([0xDEADBEEF, 0x01234567], dtype=np.uint32)
    want = words.view(np.int32).tolist()
    forms = [words, words.tolist(), torch.tensor(words.tolist(), dtype=torch.int64),
             torch.tensor(want, dtype=torch.int32), torch.tensor(want, dtype=torch.int64)]
    for form in forms:
        k = rng_plain.key_words(form)
        assert k.dtype == torch.int32 and k.tolist() == want
    with pytest.raises(ValueError):
        rng_plain.key_words([1, 2, 3])
    with pytest.raises(ValueError):
        rng_plain.threefry_uniform_matrix(rng_plain.key_words(words), 1 << 20, 1 << 12)


def test_philox_known_answers():
    def run(key, ctr):
        c = [torch.tensor([w], dtype=torch.int64) for w in ctr]
        return [int(w) for w in rng_plain.philox4x32(key[0], key[1], *c)]

    assert run((0, 0), (0, 0, 0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = 0xFFFFFFFF
    assert run((f, f), (f, f, f, f)) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_matrix_layout_and_law():
    key = rng_plain.key_words([0x12345678, 0x9ABCDEF0])
    u = rng_plain.philox_uniform_matrix(key, 64, 50).numpy()
    assert u.shape == (50, 64) and u.dtype == np.float32
    assert (u >= 0).all() and (u < 1).all()
    # row r of lane l: word r % 4 at counter (l, r // 4, 0, 0)
    for lane, row in [(0, 0), (5, 6), (63, 49)]:
        c = [torch.tensor([w], dtype=torch.int64) for w in (lane, row // 4, 0, 0)]
        word = int(rng_plain.philox4x32(0x12345678, 0x9ABCDEF0, *c)[row % 4])
        want = np.array([(word >> 9) | 0x3F800000], dtype=np.uint32).view(np.float32)[0] - 1.0
        assert u[row, lane] == want
    # a function of (key, lane, row) only: a wider or deeper block extends it
    big = rng_plain.philox_uniform_matrix(key, 100, 53).numpy()
    assert (big[:50, :64] == u).all()
    assert len({u[:, lane].tobytes() for lane in range(64)}) == 64, "lanes share a stream"
    other = rng_plain.philox_uniform_matrix(rng_plain.key_words([1, 2]), 64, 50).numpy()
    assert (other != u).mean() > 0.99
    wide = rng_plain.philox_uniform_matrix(key, 4096, 50).numpy().ravel()
    assert abs(wide.mean() - 0.5) < 4 / np.sqrt(12 * wide.size)
    assert abs(wide.var() - 1 / 12) < 1e-3
    assert kstest(wide, "uniform").pvalue > 1e-3
    # neighbouring lanes and rows are uncorrelated
    m = rng_plain.philox_uniform_matrix(key, 4096, 50).numpy()
    assert abs(np.corrcoef(m[:, :-1].ravel(), m[:, 1:].ravel())[0, 1]) < 0.01
    assert abs(np.corrcoef(m[:-1].ravel(), m[1:].ravel())[0, 1]) < 0.01


@pytest.mark.parametrize("mode", ["threefry", "philox"])
def test_full_step_with_key_equals_full_step_on_the_plain_matrix(mode):
    cfg, ins = scenario_inputs("GoalContinuous2P-v0", 8, seed=17, raw_action=True)
    t = [torch.as_tensor(a) if a.dtype == np.int32 else torch.as_tensor(a).float() for a in ins]
    key = rng_plain.key_words([0xCAFEF00D, 42])
    keyed = FullStep(cfg, 1, 8, "bs3", in_kernel_rng=mode)
    plain = FullStep(cfg, 1, 8, "bs3")
    assert keyed.bytes_per_lane() == plain.bytes_per_lane() - 4 * plain.n_uniform_rows
    u = keyed.plain_uniforms(key, 8)
    got = keyed.apply(*t[:7], key)
    want = plain.apply(*t[:7], u.t())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[-1][2].any(), "some lane resets"
    with pytest.raises(TypeError):
        keyed.apply(*t)  # a uniforms block where the key belongs
    with pytest.raises(TypeError):
        keyed.apply(*[a.double() if a.is_floating_point() else a for a in t[:7]], key)


def test_threefry_engine_bitwise_equals_injected_jax_matrix():
    cfg = dataclasses.replace(get_config("GoalContinuous2P-v0"), max_episode_steps=1)
    B = 8
    keyed = EnvEngine(cfg, device="cpu", in_kernel_rng="threefry", tableau="bs3", substeps=1,
                      refine_iters=8)
    fed = EnvEngine(cfg, device="cpu", tableau="bs3", substeps=1, refine_iters=8)
    u0 = torch.as_tensor(np.random.default_rng(0).random((B, fed.n_reset_rand), dtype=np.float32))
    sk, _ = keyed.reset(B, u=u0)
    sf, _ = fed.reset(B, u=u0)
    act = torch.zeros((B, 2))
    for i in range(2):
        key = jax.random.key(50 + i)
        u = np.array(jax.random.uniform(key, (B, fed.n_step_rand), jnp.float32))
        sk, tk = keyed.step(sk, act, key=np.asarray(jax.random.key_data(key)))
        sf, tf = fed.step(sf, act, u=torch.as_tensor(u))
        assert tk.done.all()
        for a, b in [(sk.y, sf.y), (sk.goal_pos, sf.goal_pos), (sk.planets_pos, sf.planets_pos),
                     (tk.obs, tf.obs), (tk.reward, tf.reward)]:
            assert (_bits(a.numpy()) == _bits(b.numpy())).all()
        assert torch.equal(sk.tiling.free, sf.tiling.free)


def test_generator_drawn_keys_stay_on_the_device_and_differ():
    eng = EnvEngine(get_config("DoNotCrashContinuous-v0"), device="cpu", in_kernel_rng="philox")
    g = eng.generator(3)
    keys = [eng.draw_key(g) for _ in range(3)]
    assert all(k.dtype == torch.int32 and k.shape == (2,) and k.device == eng.device
               for k in keys)
    assert len({tuple(k.tolist()) for k in keys}) == 3
    again = eng.draw_key(eng.generator(3))
    assert torch.equal(again, keys[0])


def test_philox_engine_reset_marginals_match_jax_fixed_tier():
    """Every lane resets at every step: the reset law is under test.  The JAX
    fixed tier runs at the port engine's depth (one substep, 8 refinements),
    which also halves the trace of its step."""
    cfg = dataclasses.replace(get_config("GoalContinuous2P-v0"), max_episode_steps=1)
    jcfg = dataclasses.replace(space_gym_tpu.get_config("GoalContinuous2P-v0"),
                               max_episode_steps=1)
    ep = EnvEngine(cfg, device="cpu", in_kernel_rng="philox", tableau="bs3", substeps=1,
                   refine_iters=8)
    ex = JaxEngine(jcfg, physics="fixed", dtype=jnp.float32, substeps=1, refine_iters=8)
    B = 512
    g = ep.generator(0)
    sp, _ = ep.init(B, g)
    sx, _ = ex.init(jax.random.key(0), B)
    YP, YX, GP, GX = [], [], [], []
    for i in range(4):
        sp, tp = ep.step(sp, torch.zeros((B, 2)), g)
        sx, _ = ex.step(sx, jnp.zeros((B, 2), jnp.float32), jax.random.key(200 + i))
        assert tp.done.all()
        YP.append(sp.y.numpy()); YX.append(np.asarray(sx.y))
        GP.append(sp.goal_pos.numpy()); GX.append(np.asarray(sx.goal_pos))
    YP, YX, GP, GX = (np.concatenate(v) for v in (YP, YX, GP, GX))
    for name, a, b in [
        ("ship x", YP[:, 0], YX[:, 0]),
        ("speed", np.hypot(YP[:, 3], YP[:, 4]), np.hypot(YX[:, 3], YX[:, 4])),
        ("ang vel", YP[:, 5], YX[:, 5]),
        ("goal x", GP[:, 0], GX[:, 0]),
        ("ship-goal", np.linalg.norm(GP - YP[:, :2], axis=-1),
         np.linalg.norm(GX - YX[:, :2], axis=-1)),
    ]:
        assert ks_2samp(a, b).pvalue > 1e-3, name
