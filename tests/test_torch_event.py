"""Port parity, ``solver/event.py``: ``odeint_event`` against the JAX
package's on the cases of ``tests/test_event.py`` (float64, on the CPU):
``fired`` and the per-sample NFE equal, ``t_event`` and ``y_event`` within
1e-8, and each case's own analytic check on the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.solver import odeint_event as jax_event
from neural_ode_features_tpu_torch.solver import odeint_event

torch.set_num_threads(2)

TOLS = dict(rtol=1e-9, atol=1e-12)
LOOSE = dict(rtol=1e-3, atol=1e-6)
EVENT_TOL = 1e-8
F64 = torch.float64


def _decay(t, y):
    return -y


def _osc(t, s):
    return {"y": s["v"], "v": -s["y"]}


def _arr(x, torch_side):
    return torch.tensor(x, dtype=F64) if torch_side else jnp.asarray(
        x, jnp.float64)


def _sin(t, torch_side):
    return torch.sin(t) if torch_side else jnp.sin(t)


# Each case: (y0, event_fn(t, y, torch_side), kwargs, analytic check on the
# port's solution or None); the dynamics act alike on both sides.
CASES = {
    "exponential_threshold_global": (
        [2.0], lambda t, y, ts_: y[0] - 1.0, dict(t_max=5.0, **TOLS),
        lambda s: (bool(s.fired) and abs(float(s.t_event) - math.log(2.0))
                   < 1e-7)),
    "no_event_reaches_t_max": (
        [2.0], lambda t, y, ts_: y[0] - 0.001, dict(t_max=1.5, **TOLS),
        lambda s: not bool(s.fired) and float(s.t_event) == 1.5),
    "time_only_event": (
        [1.0], lambda t, y, ts_: t - 0.3, dict(t_max=2.0, **TOLS),
        lambda s: abs(float(s.t_event) - 0.3) < 1e-7),
    "backward_time": (
        [1.0], lambda t, y, ts_: y[0] - 2.0, dict(t_max=-3.0, **TOLS),
        lambda s: abs(float(s.t_event) + math.log(2.0)) < 1e-7),
    "per_sample_events": (
        [[2.0], [4.0], [8.0]], lambda t, y, ts_: y[:, 0] - 1.0,
        dict(t_max=5.0, error_control="per_sample", **TOLS),
        lambda s: np.allclose(s.t_event.numpy(), np.log([2.0, 4.0, 8.0]),
                              atol=1e-7)),
    "per_sample_mixed_fired": (
        [[2.0], [2.0]],
        lambda t, y, ts_: y[:, 0] - _arr([1.0, 0.001], ts_),
        dict(t_max=1.5, error_control="per_sample", **TOLS),
        lambda s: (s.fired.tolist() == [True, False]
                   and float(s.t_event[1]) == 1.5)),
    "pi_controller": (
        [2.0], lambda t, y, ts_: y[0] - 1.0,
        dict(t_max=5.0, controller="pi", **TOLS),
        lambda s: abs(float(s.t_event) - math.log(2.0)) < 1e-7),
    "tsit5": (
        [2.0], lambda t, y, ts_: y[0] - 1.0,
        dict(t_max=5.0, method="tsit5", **TOLS),
        lambda s: abs(float(s.t_event) - math.log(2.0)) < 1e-7),
    "direction_no_matching_crossing": (
        [2.0], lambda t, y, ts_: y[0] - 1.0,
        dict(t_max=3.0, direction=1, **TOLS),
        lambda s: not bool(s.fired) and float(s.t_event) == 3.0),
    "interior_probes_miss": (
        [2.0], lambda t, y, ts_: _sin(t, ts_) - 0.999,
        dict(t_max=10.0, **LOOSE), lambda s: not bool(s.fired)),
    "interior_probes_catch": (
        [2.0], lambda t, y, ts_: _sin(t, ts_) - 0.999,
        dict(t_max=10.0, interior_probes=16, **LOOSE),
        lambda s: (bool(s.fired)
                   and abs(float(s.t_event) - math.asin(0.999)) < 1e-4)),
    "event_at_t0_fires_immediately": (
        [1.0], lambda t, y, ts_: y[0] - 1.0,
        dict(t_max=5.0, direction=1, **TOLS),
        lambda s: bool(s.fired) and float(s.t_event) == 0.0),
    "degenerate_span_no_nan": (
        [2.0], lambda t, y, ts_: y[0] - 1.0, dict(t_max=0.0, **TOLS),
        lambda s: (not bool(s.fired) and float(s.t_event) == 0.0
                   and bool(s.stats.success.all()))),
    "nan_event_fn_never_fires": (
        [2.0], lambda t, y, ts_: y[0] * float("nan"),
        dict(t_max=1.0, **TOLS),
        lambda s: not bool(s.fired) and float(s.t_event) == 1.0),
    "max_steps_exhausted_reports_running_position": (
        [2.0], lambda t, y, ts_: y[0] - 0.001,
        dict(t_max=500.0, max_steps=5, first_step=0.1, **TOLS),
        lambda s: (not bool(s.stats.success.all())
                   and 0.0 < float(s.t_event) < 500.0
                   and abs(float(s.y_event[0])
                           - 2.0 * math.exp(-float(s.t_event))) < 1e-6)),
}


def _jax_event(func, y0, event_fn, **kw):
    """The JAX solve from t0 = 0, jitted as one program (one compile in
    place of the many of an eager solve)."""
    return jax.jit(lambda y: jax_event(func, y, 0.0, event_fn, **kw))(y0)


def _compare(sol, sol_j):
    np.testing.assert_array_equal(sol.fired.numpy(), np.asarray(sol_j.fired))
    np.testing.assert_allclose(sol.t_event.numpy(), np.asarray(sol_j.t_event),
                               rtol=0, atol=EVENT_TOL)
    for name in ("nfe", "naccept", "nreject", "success"):
        np.testing.assert_array_equal(getattr(sol.stats, name).numpy(),
                                      np.asarray(getattr(sol_j.stats, name)))


@pytest.mark.parametrize("case", list(CASES))
def test_event_matches_jax(case):
    y0, event, kw, check = CASES[case]
    sol_j = _jax_event(_decay, _arr(y0, False),
                       lambda t, y: event(t, y, False), **kw)
    sol = odeint_event(_decay, _arr(y0, True), 0.0,
                       lambda t, y: event(t, y, True), **kw)
    _compare(sol, sol_j)
    np.testing.assert_allclose(sol.y_event.numpy(), np.asarray(sol_j.y_event),
                               rtol=0, atol=EVENT_TOL)
    assert sol.t_event.shape == tuple(np.shape(sol_j.t_event))
    assert check(sol)


@pytest.mark.parametrize("direction", [0, -1, 1])
def test_oscillator_crossings_match_jax(direction):
    """cos t falls through zero at π/2 and rises at 3π/2: a tree state,
    global control; ``direction=+1`` steps over the first crossing."""
    s0 = {k: np.asarray(v) for k, v in (("y", 1.0), ("v", 0.0))}
    kw = dict(t_max=10.0, direction=direction, **TOLS)
    sol_j = _jax_event(_osc, {k: jnp.asarray(v) for k, v in s0.items()},
                       lambda t, s: s["y"], **kw)
    sol = odeint_event(_osc, {k: torch.tensor(v, dtype=F64)
                              for k, v in s0.items()}, 0.0,
                       lambda t, s: s["y"], **kw)
    _compare(sol, sol_j)
    for k in ("y", "v"):
        np.testing.assert_allclose(float(sol.y_event[k]),
                                   float(sol_j.y_event[k]), atol=EVENT_TOL)
    want = 3 * math.pi / 2 if direction == 1 else math.pi / 2
    assert abs(float(sol.t_event) - want) < 1e-6


def test_misuse_raises():
    y0 = torch.tensor([1.0], dtype=F64)
    with pytest.raises(ValueError, match="adaptive RK"):
        odeint_event(_decay, y0, 0.0, lambda t, y: y[0], t_max=1.0,
                     method="euler")
    with pytest.raises(ValueError, match="error_control"):
        odeint_event(_decay, y0, 0.0, lambda t, y: y[0], t_max=1.0,
                     error_control="bogus")
    with pytest.raises(ValueError, match="event_fn must return"):
        odeint_event(_decay, torch.ones((2, 3), dtype=F64), 0.0,
                     lambda t, y: y, t_max=1.0, error_control="per_sample")
    with pytest.raises(ValueError, match="direction"):
        odeint_event(_decay, y0, 0.0, lambda t, y: y[0], t_max=1.0,
                     direction=2)
    with pytest.raises(ValueError, match="interior_probes"):
        odeint_event(_decay, y0, 0.0, lambda t, y: y[0], t_max=1.0,
                     interior_probes=-1)
