"""The port's adaptive RK45 (space_gym_torch/ops/rk45.py::solve_step) against
scipy's solve_ivp on the cases of tests/test_rk45.py, run as lanes of one
batch, at that file's tolerances (1e-13 in free flight, 1e-12 where an event
fires or on the random states); its Brent's method against scipy's; a batch
against its lanes run alone; and a singular lane, which must fail without
holding up the others.
"""
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp
from scipy.optimize import brentq as scipy_brentq

from space_gym_torch.ops import events, field, rk45

from .test_rk45 import DNC_SHIP, GOAL_SHIP, np_events, np_rhs
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

GOAL = field.ShipParams(*GOAL_SHIP)
DNC = field.ShipParams(*DNC_SHIP)
# (ship, planet masses, planet radii, world size, max |omega|): the settings
# of tests/test_rk45.py's cases
SETTINGS = {
    "goal": (GOAL, (5e8, 5e8), (0.3, 0.3), 3.0, 6.0),
    "dnc": (DNC, (6e8, 0.0), (0.25, 1.0), 2.0, 5.0),
    "border": (GOAL, (0.0, 0.0), (0.25, 1e9), 2.0, 5.0),
    "spin": (DNC, (0.0,), (0.25,), 4.0, 5.0),
    # close flybys of heavy planets: steps get rejected (not a reference case)
    "heavy": (GOAL, (3e10, 3e10), (0.05, 0.05), 3.0, 6.0),
}
ZEROS = [[0.0, 0.0], [0.0, 0.0]]
# (name, setting, planets, y0, action, t1, atol, terminates)
CASES = [
    ("velocity_free_flight", "goal", [[0.4, -0.3], [-0.8, 0.9]],
     [0.1, 0.2, 1.3, 0.05, -0.02, 0.0], [0.7, -0.4], 0.07, 1e-13, False),
    ("acceleration_free_flight", "dnc", ZEROS, [0.5, 0.1, 2.0, 0.01, 0.04, 0.3], [1.0, 1.0],
     0.07, 1e-13, False),
    ("planet_crash", "dnc", ZEROS, [0.5, 0.0, np.pi, -4.5, 0.0, 0.0], [0.0, 0.0], 0.07, 1e-12,
     True),
    ("world_boundary", "border", ZEROS, [0.9, 0.0, 0.0, 3.0, 0.0, 0.0], [-1.0, 0.0], 0.07, 1e-12,
     True),
    ("angular_velocity", "spin", [[0.0, 0.0]], [0.5, 0.5, 0.0, 0.0, 0.0, 4.9], [0.0, 1.0], 0.5,
     1e-12, True),
]
for _seed in range(25):  # test_rk45.py::test_random_states_match
    _r = np.random.RandomState(_seed)
    _planets = _r.uniform(-1, 1, (2, 2))
    _y0 = np.concatenate([_r.uniform(-1.2, 1.2, 2), [_r.uniform(0, 2 * np.pi)],
                          _r.standard_normal(2) * 0.2, [_r.uniform(-4, 4)]])
    _action = [_r.uniform(0, 1), _r.uniform(-1, 1)]
    CASES.append((f"random_{_seed}", "goal", _planets, _y0, _action, 0.07, 1e-12, None))
FLYBYS = []  # lanes whose controller rejects steps, some several times in a row
for _seed in (1, 2, 18):
    _r = np.random.RandomState(2000 + _seed)
    _planets = np.array([[0.4, -0.3], [-0.8, 0.9]])
    _a, _d = _r.uniform(0, 2 * np.pi), _r.uniform(0.08, 0.3)
    _pos = _planets[0] + _d * np.array([np.cos(_a), np.sin(_a)])
    _speed, _va = _r.uniform(0.5, 3.0), _a + np.pi / 2 + _r.uniform(-0.5, 0.5)
    _y0 = [*_pos, _r.uniform(0, 6.28), _speed * np.cos(_va), _speed * np.sin(_va), 0.0]
    FLYBYS.append((f"flyby_{_seed}", "heavy", _planets, _y0,
                   [_r.uniform(0, 1), _r.uniform(-1, 1)], 0.07, None, None))
NAMES = list(SETTINGS)
N_EVENTS = 5  # the most planets of a setting, plus three


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def batch(cases):
    """The cases as one batch: y0 (B, 6) after the steering override, the
    right-hand side and event function of each lane's setting, t_bound (B,)
    and the event_args (planets (B, 2, 2), setting index (B,))."""
    B = len(cases)
    planets = np.zeros((B, 2, 2))
    for i, c in enumerate(cases):
        planets[i, :len(c[2])] = c[2]
    planets, action = _t(planets), _t([c[4] for c in cases])
    which = torch.tensor([NAMES.index(c[1]) for c in cases])
    y0 = _t([c[3] for c in cases])

    def per_setting(fn):
        """Each lane's row of fn(setting, lanes' rows) over the settings."""
        def run(rows, *lane_args):
            idx = lane_args[-1]
            out = None
            for k, name in enumerate(NAMES):
                got = fn(SETTINGS[name], rows, *lane_args[:-1])
                out = got if out is None else torch.where((idx == k)[:, None], got, out)
            return out
        return run

    def rhs_of(setting, y, p, a):
        ship, masses = setting[0], setting[1]
        return field.ship_vector_field(ship, masses, p[:, :len(masses)], a, y)

    def ev_of(setting, y, p):
        _, masses, radii, world, max_w = setting
        g = events.make_event_fn(radii, world, max_w)(p[:, :len(masses)], y)
        pad = torch.ones((y.shape[0], N_EVENTS - g.shape[1]), dtype=y.dtype)
        return torch.cat([g, pad], dim=1)  # the pad never changes sign

    rhs_all = per_setting(rhs_of)
    y0 = per_setting(lambda s, y, a: field.apply_steering_override(s[0], y, a))(y0, action, which)
    t1 = _t([c[5] for c in cases])
    return (y0, lambda _t_, y: rhs_all(y, planets, action, which), per_setting(ev_of), t1,
            (planets, which))


def scipy_solve(case):
    _, setting, planets, y0, action, t1, _, _ = case
    ship, masses, radii, world, max_w = SETTINGS[setting]
    planets = np.asarray(planets, np.float64)
    sol = solve_ivp(np_rhs(ship, masses, planets, np.asarray(action, np.float64)), (0, t1),
                    np.asarray(y0, np.float64).copy(), method="RK45",
                    events=np_events(radii, planets, world, max_w))
    assert sol.success
    return sol.y[:, -1], sol.status == 1


def test_solve_step_matches_scipy_on_one_batch():
    y0, rhs, ev, t1, args = batch(CASES)
    stats = {}
    out = rk45.solve_step(rhs, ev, y0, t1, event_args=args, stats=stats)
    assert out.y.dtype == torch.float64 and not out.failed.any()
    assert stats["brent_lanes"] >= 3 and stats["syncs"] > 0
    for i, case in enumerate(CASES):
        name, atol, terminates = case[0], case[6], case[7]
        y_ref, done_ref = scipy_solve(case)
        assert bool(out.terminated[i]) == done_ref, name
        if terminates is not None:
            assert done_ref == terminates, name
        np.testing.assert_allclose(out.y[i].numpy(), y_ref, rtol=0, atol=atol, err_msg=name)
        if done_ref:
            assert 0 < float(out.t[i]) < case[5], name
    # the crash returns the state at the event time: on the planet's surface
    crash = [c[0] for c in CASES].index("planet_crash")
    assert abs(float(out.y[crash, :2].norm()) - 0.25) < 1e-9


def test_batch_equals_each_lane_alone():
    """A lane comes back with the bits it has when no other lane keeps the
    loops running.  Lanes of mixed fates (free flight, crash, border, spin,
    random states, flybys whose steps get rejected, up to three times in a
    row) against each lane alone: a batch of copies of that lane,
    so that the lane keeps its place in the batch (PyTorch's CPU kernels
    take a vector or a scalar libm by position: 2.5% of float64 `pow`
    results differ by an ulp between the two)."""
    cases = CASES[:13] + FLYBYS
    y0, rhs, ev, t1, args = batch(cases)
    out = rk45.solve_step(rhs, ev, y0, t1, event_args=args)
    assert out.terminated[2:5].all() and not out.terminated[:2].any()
    assert len(set(out.n_steps.tolist())) > 1
    for i, c in enumerate(cases):
        y0_i, rhs_i, ev_i, t1_i, args_i = batch([c] * len(cases))
        alone = rk45.solve_step(rhs_i, ev_i, y0_i, t1_i, event_args=args_i)
        for f in rk45.SolveResult._fields:
            assert torch.equal(getattr(alone, f)[i], getattr(out, f)[i]), (c[0], f)


def test_brentq_matches_scipy():
    """A batch of brackets, each function of its element, against scipy's
    brentq at solve_ivp's tolerances (4 eps): polynomials, so both sides
    evaluate them with the same bits; the roots come back bit for bit."""
    eps4 = 4 * np.finfo(np.float64).eps
    fns = [
        (lambda x: x ** 3 - 2.0, 0.0, 2.0),
        (lambda x: (x - 0.3) * (x + 1.7) * (x - 0.31), 0.305, 1.0),
        (lambda x: 1e-6 - x * x, 0.0, 1.0),
        (lambda x: x * x * x * x - 0.5 * x - 0.1, 0.5, 1.2),
        (lambda x: 0.07 - x, 0.0, 0.07),  # a root at an end of the bracket
        (lambda x: 2.0 * x - 1.0, 0.0, 1.0),
    ]
    want = [scipy_brentq(f, a, b, xtol=eps4, rtol=eps4) for f, a, b in fns]
    xa, xb = _t([a for _, a, _ in fns]), _t([b for _, _, b in fns])

    def f_batch(x):
        return torch.stack([f(x[i]) for i, (f, _, _) in enumerate(fns)])

    got = rk45.brentq(f_batch, xa, xb, eps4, eps4)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_singular_lane_fails_and_the_others_stay_finite():
    """A ship at a planet's centre has a non-finite right-hand side: its lane
    fails (the controller's NaN guards) within `max_steps`, and the other
    lanes of the batch come back as they do without it."""
    cases = [CASES[0], CASES[5], CASES[6]]
    sing = list(CASES[0])
    sing[3] = [0.4, -0.3, 1.3, 0.05, -0.02, 0.0]  # on planet 0
    y0, rhs, ev, t1, args = batch(cases + [tuple(sing)])
    out = rk45.solve_step(rhs, ev, y0, t1, event_args=args, max_steps=50)
    assert bool(out.failed[3]) and not out.failed[:3].any()
    assert int(out.n_steps.max()) <= 50
    y0_ok, rhs_ok, ev_ok, t1_ok, args_ok = batch(cases + [cases[0]])
    ok = rk45.solve_step(rhs_ok, ev_ok, y0_ok, t1_ok, event_args=args_ok, max_steps=50)
    assert torch.isfinite(out.y[:3]).all()
    assert torch.equal(out.y[:3], ok.y[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_dtype_end_to_end(dtype):
    """float32 and float64 states keep their dtype in every output; float32
    agrees with float64 to its own precision."""
    y0, rhs, ev, t1, args = batch(CASES[:8])
    cast = dict(dtype=dtype)
    p, w = args

    def rhs_d(t, y):
        return rhs(t, y.double()).to(dtype) if dtype != torch.float64 else rhs(t, y)

    out = rk45.solve_step(rhs_d, lambda y, pp, ww: ev(y.double(), pp, ww).to(dtype),
                          y0.to(**cast), t1.to(**cast), event_args=(p, w))
    assert out.y.dtype == dtype and out.t.dtype == dtype
    ref = rk45.solve_step(rhs, ev, y0, t1, event_args=args)
    assert torch.equal(out.terminated, ref.terminated)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(out.y.double().numpy(), ref.y.numpy(), rtol=0, atol=tol)
