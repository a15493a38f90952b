"""The port's numpy-exact ops (space_gym_torch/ops/exact.py) against numpy.

In the parity mode each op must give numpy's bits on a few thousand seeded
inputs: the definition that space_gym_tpu/ops/exact.py reproduces (numpy's
OpenBLAS for norms and dots, libm for pow, cos, sin and sqrt, np.arctan2,
true divisions).  Outside the mode each op must be the plain PyTorch
expression the engine computes without it, with no call into the library,
and the mode must not leak past its block or into another thread.
Tolerance: none, bit for bit.
"""
import threading

import numpy as np
import pytest
import torch

from space_gym_torch.ops import exact
from space_gym_torch.ops.rk45 import DP_A, DP_B, DP_E, DP_P

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

N = 3000
COEFFS = {**{s: DP_A[s] for s in range(1, 6)}, 6: DP_B, 7: DP_E}  # kt_dot's `which`


def _rng(seed=0):
    return np.random.default_rng(seed)


def _in_parity(fn, *args):
    with exact.parity():
        return fn(*args).numpy()


@pytest.mark.parametrize("n", [2, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_norm_last_is_numpy_norm(n, dtype):
    v = _rng(n).normal(size=(N, n)).astype(dtype) * 3
    got = _in_parity(exact.norm_last, torch.as_tensor(v))
    want = np.array([np.linalg.norm(row) for row in v])
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", range(1, 8))
def test_kt_dot_is_numpy_dot(which):
    coeffs = np.array(COEFFS[which])
    s = len(coeffs)
    K = _rng(which).normal(size=(N // 10, 7, 6))
    got = _in_parity(exact.kt_dot, torch.as_tensor(K[:, :s]), which)
    want = np.stack([np.dot(k[:s].T, coeffs) for k in K])
    np.testing.assert_array_equal(got, want)


def test_ktp_is_numpy_dot():
    K = _rng(8).normal(size=(N // 10, 7, 6))
    P = np.array(DP_P)
    got = _in_parity(exact.ktp, torch.as_tensor(K))
    np.testing.assert_array_equal(got, np.stack([np.dot(k.T, P) for k in K]))


@pytest.mark.parametrize("m,n", [(6, 4), (2, 2)])
def test_dot_mv_is_numpy_dot(m, n):
    r = _rng(m)
    A, x = r.normal(size=(N, m, n)), r.normal(size=(N, n))
    got = _in_parity(exact.dot_mv, torch.as_tensor(A), torch.as_tensor(x))
    np.testing.assert_array_equal(got, np.stack([np.dot(a, b) for a, b in zip(A, x)]))


@pytest.mark.parametrize("e", [2, -0.2, 0.5])
def test_powf_is_numpy_scalar_pow(e):
    x = _rng(3).uniform(1e-3, 5, N)
    got = _in_parity(exact.powf, torch.as_tensor(x), e)
    np.testing.assert_array_equal(got, np.array([np.float64(v) ** e for v in x]))


@pytest.mark.parametrize("name", ["atan2", "cos", "sin", "sqrt", "divc", "rdivc"])
def test_elementwise_op_is_numpy(name):
    r = _rng(4)
    y, x = r.uniform(-7, 7, N), r.uniform(-7, 7, N)
    pos = np.abs(x) + 1e-3
    ty, tx, tpos = (torch.as_tensor(a) for a in (y, x, pos))
    got, want = {
        "atan2": (lambda: _in_parity(exact.atan2, ty, tx), lambda: np.arctan2(y, x)),
        "cos": (lambda: _in_parity(exact.cos, tx), lambda: np.cos(x)),
        "sin": (lambda: _in_parity(exact.sin, tx), lambda: np.sin(x)),
        "sqrt": (lambda: _in_parity(exact.sqrt, tpos), lambda: np.sqrt(pos)),
        "divc": (lambda: _in_parity(exact.divc, tx, 3.0), lambda: x / 3.0),
        "rdivc": (lambda: _in_parity(exact.rdivc, 0.01, tpos), lambda: 0.01 / pos),
    }[name]
    np.testing.assert_array_equal(got(), want())


def test_shapes_the_library_cannot_take_raise():
    with exact.parity():
        with pytest.raises(ValueError, match="reads 7 stages"):
            exact.kt_dot(torch.zeros(4, 6, 6, dtype=torch.float64), exact.WHICH_E)
        with pytest.raises(ValueError, match="7 stages"):
            exact.ktp(torch.zeros(4, 6, 6, dtype=torch.float64))
        with pytest.raises(ValueError, match="dot_mv"):
            exact.dot_mv(torch.zeros(4, 6, 4, dtype=torch.float64), torch.zeros(4, 6))


def test_plain_mode_is_todays_expression_and_calls_nothing():
    """Outside parity(): the expressions the port computed before the parity
    tier, bit for bit, and not one call into the host library."""
    r = _rng(5)
    v = torch.as_tensor(r.normal(size=(64, 6)))
    x = torch.as_tensor(r.uniform(0.1, 5, 64))
    A = torch.as_tensor(r.normal(size=(64, 6, 4)))
    p = torch.as_tensor(r.normal(size=(64, 4)))
    calls = dict(exact.counts)
    pairs = [
        (exact.norm_last(v), torch.linalg.norm(v, dim=-1)),
        (exact.powf(x, -0.2), x ** -0.2),
        (exact.atan2(x, v[:, 0]), torch.atan2(x, v[:, 0])),
        (exact.cos(x), torch.cos(x)),
        (exact.sin(x), torch.sin(x)),
        (exact.sqrt(x), torch.sqrt(x)),
        (exact.divc(x, 3), x / 3),
        (exact.rdivc(0.01, x), 0.01 / x),
        (exact.dot_mv(A, p), (A @ p[..., None])[..., 0]),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert exact.counts == calls
    with pytest.raises(RuntimeError, match="parity-mode only"):
        exact.kt_dot(A, 6)
    with pytest.raises(RuntimeError, match="parity-mode only"):
        exact.ktp(A)


def test_the_mode_does_not_leak():
    seen = {}

    def other_thread():
        seen["other"] = exact.enabled()

    assert not exact.enabled()
    with exact.parity():
        assert exact.enabled()
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        with exact.parity():
            assert exact.enabled()
        assert exact.enabled()
    assert not seen["other"]
    assert not exact.enabled()
    with pytest.raises(ValueError):
        with exact.parity():
            raise ValueError
    assert not exact.enabled()


def test_missing_openblas_or_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a numpy without its OpenBLAS, or a source that does not
    compile, raises with the cause."""
    monkeypatch.setattr(exact, "_lib", None)
    monkeypatch.setattr(exact, "openblas_path", lambda: None)
    with pytest.raises(RuntimeError, match="bundles no OpenBLAS"):
        exact.load()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(exact, "_SRC", str(bad))
    monkeypatch.setattr(exact, "_LIB", str(tmp_path / "libbad.so"))
    with pytest.raises(RuntimeError, match="did not build"):
        exact.load()
