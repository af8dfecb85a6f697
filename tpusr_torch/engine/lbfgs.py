"""L-BFGS over one flat parameter vector on the device.

Two steppers, the two that tpusr's DIP engine runs after its Adam warm-up:

  * ``lbfgs_fixed_init`` / ``lbfgs_fixed_step`` — tpusr's
    ``lbfgs_fixed_step_tx`` (tpusr/engine/dip.py:84-176), which is
    ``torch.optim.LBFGS(lr, line_search_fn=None)`` stepping with the
    tolerance exits off: a pair (s, y) enters the memory only when
    y.s > 1e-10, H_diag = y.s / y.y is recomputed only then, the first step
    is min(1, 1/||g||_1) * lr and every later one lr; empty slots hold
    s = y = rho = 0 and contribute nothing. No host sync.
  * ``ZoomLBFGS`` — ``optax.lbfgs(memory_size)`` as optax 0.2.6 builds it:
    ``scale_by_lbfgs(memory_size, scale_init_precond=True)`` ->
    ``scale(-1)`` -> ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`` (optax/_src/alias.py:2598,
    transform.py:1573, linesearch.py:576 and :1331), with the accepted
    trial's value and gradient reused for the next direction, as
    ``optax.value_and_grad_from_state`` does. The vectors stay on the
    device; the line search's control flow runs on the host in float64
    over the values and slopes it reads back: one sync for the initial
    slope of each iteration and one per trial point.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# scale_by_zoom_linesearch's defaults, as optax.lbfgs takes them
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
TOL = 0.0


# ------------------------------------------------------------- fixed step
def lbfgs_fixed_init(n: int, memory_size: int, device=None) -> dict:
    """The state of ``lbfgs_fixed_step`` for an n-vector (f32)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"s_mem": zeros(memory_size, n), "y_mem": zeros(memory_size, n),
            "rho": zeros(memory_size), "prev_g": zeros(n),
            "prev_d": zeros(n), "prev_t": zeros(), "h_diag": zeros() + 1.0,
            "count": 0}


def lbfgs_fixed_step(grad: torch.Tensor, state: dict,
                     learning_rate: float) -> tuple[torch.Tensor, dict]:
    """One torch-exact L-BFGS step: (update to add to the parameters, new
    state). ``grad`` is the flat gradient at the current parameters."""
    g = grad.float()
    first = state["count"] == 0
    m = state["rho"].shape[0]

    # memory admission (iterations >= 2 in torch's numbering)
    y = g - state["prev_g"]
    s = state["prev_d"] * state["prev_t"]
    ys = torch.dot(y, s)
    good = (ys > 1e-10) & (not first)

    def admit(mem, row):
        return torch.where(good, torch.cat([mem[1:], row[None]]), mem)

    s_mem = admit(state["s_mem"], s)
    y_mem = admit(state["y_mem"], y)
    rho = admit(state["rho"][:, None],
                (1.0 / torch.where(good, ys, 1.0)).reshape(1))[:, 0]
    h_diag = torch.where(good, ys / torch.dot(y, y),
                         torch.ones_like(ys) if first else state["h_diag"])

    # two-loop recursion over the memory, oldest slot first
    q = -g
    al = [None] * m
    for i in reversed(range(m)):
        al[i] = rho[i] * torch.dot(s_mem[i], q)
        q = q - al[i] * y_mem[i]
    r = h_diag * q
    for i in range(m):
        be = rho[i] * torch.dot(y_mem[i], r)
        r = r + (al[i] - be) * s_mem[i]
    d = r

    if first:
        t = torch.clamp(1.0 / g.abs().sum(), max=1.0) * learning_rate
    else:
        t = torch.full((), learning_rate, device=g.device)
    new_state = {"s_mem": s_mem, "y_mem": y_mem, "rho": rho, "prev_g": g,
                 "prev_d": d, "prev_t": t, "h_diag": h_diag,
                 "count": state["count"] + 1}
    return (t * d).to(grad.dtype), new_state


# ----------------------------------------------------- zoom line search
def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where none exists (then it is not used)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * rb + -(db ** 2) * rc) / denom
    B = (-(dc ** 3) * rb + db ** 3 * rc) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's sufficient decrease, or Hager and Zhang's approximate one
    near a minimum, whichever is smaller; 0 when met, inf for NaN."""
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    err = np.minimum(np.maximum(approx, delta), err)
    err = np.maximum(err, 0.0)
    return np.inf if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), 0.0)
    return np.inf if np.isnan(err) else err


class _Point:
    """A trial stepsize with its value, slope and (device) gradient."""

    __slots__ = ("t", "value", "slope", "grad")

    def __init__(self, t, value, slope, grad):
        self.t, self.value, self.slope, self.grad = t, value, slope, grad


def zoom_linesearch(x, u, value, grad, value_and_grad):
    """optax's zoom line search from x along u, starting at stepsize 1.

    Interval search (Nocedal and Wright, Algorithm 3.5), then zoom (3.6)
    by cubic, quadratic or bisection steps; at most MAX_LINESEARCH_STEPS
    trial points. On failure it falls back to the best point that met the
    decrease criterion (or to stepsize 0 when every trial was NaN/inf).
    Returns (the chosen _Point, number of trial points)."""
    f64 = np.float64
    slope0 = f64(torch.dot(u, grad).item())
    value0 = f64(value)
    init = _Point(f64(0.0), value0, slope0, grad)
    cur, safe = init, init
    low = high = cubic_ref = init
    count, interval_found, done, failed = 0, False, False, False
    dec = f64(np.inf)

    def trial(t):
        v, g = value_and_grad(x + u * float(t))
        v, s = torch.stack([v.double(), torch.dot(g, u).double()]).tolist()
        return _Point(f64(t), f64(v), f64(s), g)

    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                prev = cur
                t = f64(1.0) if count == 0 else INCREASE_FACTOR * prev.t
                new = trial(t)
                dec = _decrease_error(new.t, new.value, new.slope, value0,
                                      slope0)
                err = max(dec, _curvature_error(new.slope, slope0))
                if dec <= TOL:
                    safe = new
                set_high = dec > 0.0 or (new.value >= prev.value
                                         and count > 0)
                set_low = new.slope >= 0.0 and not set_high
                low, high = (new, prev) if set_low else (prev, new)
                cubic_ref = low
                interval_found = set_high or set_low or err <= TOL
                done = err <= TOL
                failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
            else:
                delta = np.abs(high.t - low.t)
                left, right = min(high.t, low.t), max(high.t, low.t)
                too_small = delta <= STEPSIZE_PRECISION
                mc = _cubicmin(low.t, low.value, low.slope, high.t,
                               high.value, cubic_ref.t, cubic_ref.value)
                mq = _quadmin(low.t, low.value, low.slope, high.t,
                              high.value)
                if left + 0.2 * delta < mc < right - 0.2 * delta:
                    t = mc
                elif left + 0.1 * delta < mq < right - 0.1 * delta:
                    t = mq
                else:
                    t = (low.t + high.t) / 2.0
                new = trial(t)
                dec = _decrease_error(new.t, new.value, new.slope, value0,
                                      slope0)
                err = max(dec, _curvature_error(new.slope, slope0))
                if dec <= TOL and new.value < safe.value:
                    safe = new
                done = err <= TOL
                high_to_middle = dec > 0.0 or new.value >= low.value
                high_to_low = (new.slope * (high.t - low.t) >= 0.0
                               and not high_to_middle)
                cubic_ref = high if high_to_middle or high_to_low else low
                new_high = low if high_to_low else (
                    new if high_to_middle else high)
                if not high_to_middle:
                    low = new
                high = new_high
                failed = ((count + 1 >= MAX_LINESEARCH_STEPS
                           or (too_small and safe.t > 0.0)) and not done)
            cur = new
            count += 1
            if failed and (safe.t > 0.0 or np.isinf(dec)):
                cur = safe
    return cur, count


class ZoomLBFGS:
    """optax.lbfgs(memory_size) over a flat vector: the L-BFGS direction
    with a scaled-identity initial preconditioner, then the zoom line
    search. ``step(x, value_and_grad)`` makes one iteration and returns
    (new x, the value at x); ``linesearch_steps`` lists each iteration's
    trial points and ``evals`` counts every value-and-gradient call."""

    def __init__(self, n: int, memory_size: int, device=None,
                 dtype=torch.float32):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size
        self.count = 0
        self.dw = torch.zeros(memory_size, n, dtype=dtype, device=device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(memory_size, dtype=dtype, device=device)
        self.params = self.updates = None
        self.value, self.grad = math.inf, None
        self.linesearch_steps: list[int] = []
        self.evals = 0

    def _direction(self, x, g):
        """scale_by_lbfgs: admit (x - x_prev, g - g_prev), then the two-loop
        product P g, with P's initial scale y.s / y.y (min(1, 1/||g||) at
        the first iteration)."""
        m, k = self.m, self.count
        if k > 0:
            dp, du = x - self.params, g - self.updates
            vd = torch.dot(du, dp)
            den = torch.dot(du, du)
            prev = (k - 1) % m
            self.dw[prev], self.du[prev] = dp, du
            self.rho[prev] = torch.where(vd == 0.0, 0.0, 1.0 / vd)
            scale = torch.where(den > 0.0, vd / den, 1.0)
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        order = [(k % m + j) % m for j in range(m)]
        vec, alphas = g, [None] * m
        for j in reversed(range(m)):
            i = order[j]
            alphas[j] = self.rho[i] * torch.dot(self.dw[i], vec)
            vec = vec + (-alphas[j]) * self.du[i]
        vec = scale * vec
        for j in range(m):
            i = order[j]
            beta = self.rho[i] * torch.dot(self.du[i], vec)
            vec = vec + (alphas[j] - beta) * self.dw[i]
        self.params, self.updates = x, g
        self.count += 1
        return vec

    def step(self, x, value_and_grad):
        def counted(p):
            self.evals += 1
            return value_and_grad(p)

        if math.isfinite(self.value):
            value, g = self.value, self.grad
        else:
            v, g = counted(x)
            value = v.item()
        u = -self._direction(x, g)
        point, steps = zoom_linesearch(x, u, value, g, counted)
        self.value, self.grad = float(point.value), point.grad
        self.linesearch_steps.append(steps)
        return x + u * float(point.t), value
