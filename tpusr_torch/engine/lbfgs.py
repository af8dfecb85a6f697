"""L-BFGS over a stack of flat parameter vectors on the device.

Two steppers, the two that tpusr's DIP engine runs after its Adam warm-up.
Each works on N lanes at once, an (N, n) stack of independent vectors with
a memory of their own, as ``jax.vmap`` of tpusr's step runs its lane batch;
the single-vector forms are the one-lane case of the same code.

  * ``lbfgs_fixed_init_lanes`` / ``lbfgs_fixed_step_lanes`` (one vector:
    ``lbfgs_fixed_init`` / ``lbfgs_fixed_step``) — tpusr's
    ``lbfgs_fixed_step_tx`` (tpusr/engine/dip.py:84-176), which is
    ``torch.optim.LBFGS(lr, line_search_fn=None)`` stepping with the
    tolerance exits off: a pair (s, y) enters a lane's memory only when
    y.s > 1e-10, its H_diag = y.s / y.y is recomputed only then, the first
    step is min(1, 1/||g||_1) * lr and every later one lr; empty slots hold
    s = y = rho = 0 and contribute nothing. No host sync.
  * ``ZoomLBFGSLanes`` (one vector: ``ZoomLBFGS``) — ``optax.lbfgs(
    memory_size)`` as optax 0.2.6 builds it: ``scale_by_lbfgs(memory_size,
    scale_init_precond=True)`` -> ``scale(-1)`` ->
    ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`` (optax/_src/alias.py:2598,
    transform.py:1573, linesearch.py:576 and :1331), with the accepted
    trial's value and gradient reused for the next direction, as
    ``optax.value_and_grad_from_state`` does. The vectors and the
    direction stay on the device; each lane's line search is a host-side
    state machine (``ZoomSearch``) in float64 over the values and slopes
    read back. Each round gathers the trial stepsize of every lane still
    searching and makes one batched value-and-gradient call; a lane that
    has finished holds its state and is left out of the call, as ``vmap``
    of a ``while_loop`` holds a finished lane's carry. One sync per round
    (and one for the initial slopes of each iteration).
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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each lane's dot product of two (N, n) stacks: (N,)."""
    return (a * b).sum(-1)


def _lane_col(v: torch.Tensor) -> torch.Tensor:
    """A per-lane (N,) scalar as an (N, 1) column."""
    return v[:, None]


# ------------------------------------------------------------- fixed step
def lbfgs_fixed_init_lanes(lanes: int, n: int, memory_size: int,
                           device=None, dtype=torch.float32) -> dict:
    """The state of ``lbfgs_fixed_step_lanes`` for ``lanes`` n-vectors."""
    def zeros(*shape):
        return torch.zeros((lanes, *shape), dtype=dtype, device=device)

    return {"s_mem": zeros(memory_size, n), "y_mem": zeros(memory_size, n),
            "rho": zeros(memory_size), "prev_g": zeros(n),
            "prev_d": zeros(n), "prev_t": zeros(), "h_diag": zeros() + 1.0,
            "count": 0}


def lbfgs_fixed_step_lanes(grads: torch.Tensor, state: dict,
                           learning_rate: float
                           ) -> tuple[torch.Tensor, dict]:
    """One torch-exact L-BFGS step of every lane: (the (N, n) updates to
    add to the parameters, new state). ``grads`` (N, n) are the flat
    gradients at the current parameters; the lanes step together and share
    the iteration count, nothing else."""
    g = grads.to(state["prev_g"].dtype)
    first = state["count"] == 0
    m = state["rho"].shape[1]

    # memory admission (iterations >= 2 in torch's numbering), per lane
    y = g - state["prev_g"]
    s = state["prev_d"] * _lane_col(state["prev_t"])
    ys = _dot(y, s)
    good = (ys > 1e-10) & (not first)

    def admit(mem, row):  # mem (N, m, ...), row (N, ...)
        keep = good.view(-1, *([1] * (mem.dim() - 1)))
        return torch.where(keep, torch.cat([mem[:, 1:], row[:, None]], 1),
                           mem)

    s_mem = admit(state["s_mem"], s)
    y_mem = admit(state["y_mem"], y)
    rho = admit(state["rho"], 1.0 / torch.where(good, ys, 1.0))
    h_diag = torch.where(good, ys / _dot(y, y),
                         torch.ones_like(ys) if first else state["h_diag"])

    # two-loop recursion over the memory, oldest slot first
    q = -g
    al = [None] * m
    for i in reversed(range(m)):
        al[i] = rho[:, i] * _dot(s_mem[:, i], q)
        q = q - _lane_col(al[i]) * y_mem[:, i]
    r = _lane_col(h_diag) * q
    for i in range(m):
        be = rho[:, i] * _dot(y_mem[:, i], r)
        r = r + _lane_col(al[i] - be) * s_mem[:, i]

    if first:
        t = torch.clamp(1.0 / g.abs().sum(-1), max=1.0) * learning_rate
    else:
        t = torch.full_like(ys, learning_rate)
    new_state = {"s_mem": s_mem, "y_mem": y_mem, "rho": rho, "prev_g": g,
                 "prev_d": r, "prev_t": t, "h_diag": h_diag,
                 "count": state["count"] + 1}
    return (_lane_col(t) * r).to(grads.dtype), new_state


def lbfgs_fixed_init(n: int, memory_size: int, device=None,
                     dtype=torch.float32) -> dict:
    """The state of ``lbfgs_fixed_step`` for one n-vector."""
    return lbfgs_fixed_init_lanes(1, n, memory_size, device, dtype)


def lbfgs_fixed_step(grad: torch.Tensor, state: dict,
                     learning_rate: float) -> tuple[torch.Tensor, dict]:
    """``lbfgs_fixed_step_lanes`` of one lane: ``grad`` (n,) -> (n,)."""
    upd, state = lbfgs_fixed_step_lanes(grad[None], state, learning_rate)
    return upd[0], state


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
    """A trial stepsize with its value and slope (float64)."""

    __slots__ = ("t", "value", "slope")

    def __init__(self, t, value, slope):
        f64 = np.float64
        self.t, self.value, self.slope = f64(t), f64(value), f64(slope)


class ZoomSearch:
    """optax's zoom line search of one lane from stepsize 0 along its
    direction, as a state machine: ``propose()`` gives the next trial
    stepsize, ``accept(t, value, slope, grad)`` takes what the objective
    gave there, until ``finished``.

    Interval search (Nocedal and Wright, Algorithm 3.5), then zoom (3.6)
    by cubic, quadratic or bisection steps; at most MAX_LINESEARCH_STEPS
    trial points. On failure it falls back to the best point that met the
    decrease criterion (or to stepsize 0 when every trial was NaN/inf).
    ``result()`` is (stepsize, value, gradient) of the chosen point and
    ``count`` the trial points taken. Only the newest trial's gradient and
    the best decreasing one's are kept."""

    def __init__(self, value, slope, grad):
        init = _Point(0.0, value, slope)
        self.value0, self.slope0 = init.value, init.slope
        self.cur = self.safe = self.prev = init
        self.low = self.high = self.cubic_ref = init
        self.grad_cur = self.grad_safe = grad
        self.count, self.interval_found = 0, False
        self.done = self.failed = self.too_small = False

    @property
    def finished(self) -> bool:
        return self.done or self.failed

    def propose(self) -> np.float64:
        if not self.interval_found:
            self.prev = self.cur
            return (np.float64(1.0) if self.count == 0
                    else INCREASE_FACTOR * self.prev.t)
        low, high = self.low, self.high
        delta = np.abs(high.t - low.t)
        left, right = min(high.t, low.t), max(high.t, low.t)
        self.too_small = delta <= STEPSIZE_PRECISION
        with np.errstate(all="ignore"):
            mc = _cubicmin(low.t, low.value, low.slope, high.t, high.value,
                           self.cubic_ref.t, self.cubic_ref.value)
            mq = _quadmin(low.t, low.value, low.slope, high.t, high.value)
        if left + 0.2 * delta < mc < right - 0.2 * delta:
            return mc
        if left + 0.1 * delta < mq < right - 0.1 * delta:
            return mq
        return (low.t + high.t) / 2.0

    def accept(self, t, value, slope, grad) -> None:
        with np.errstate(all="ignore"):
            self._accept(_Point(t, value, slope), grad)

    def _accept(self, new, grad):
        dec = _decrease_error(new.t, new.value, new.slope, self.value0,
                              self.slope0)
        err = max(dec, _curvature_error(new.slope, self.slope0))
        last = self.count + 1 >= MAX_LINESEARCH_STEPS
        if not self.interval_found:
            prev = self.prev
            if dec <= TOL:
                self.safe, self.grad_safe = new, grad
            set_high = dec > 0.0 or (new.value >= prev.value
                                     and self.count > 0)
            set_low = new.slope >= 0.0 and not set_high
            self.low, self.high = (new, prev) if set_low else (prev, new)
            self.cubic_ref = self.low
            self.interval_found = set_high or set_low or err <= TOL
            self.done = err <= TOL
            self.failed = last and not self.done
        else:
            low, high = self.low, self.high
            if dec <= TOL and new.value < self.safe.value:
                self.safe, self.grad_safe = new, grad
            self.done = err <= TOL
            high_to_middle = dec > 0.0 or new.value >= low.value
            high_to_low = (new.slope * (high.t - low.t) >= 0.0
                           and not high_to_middle)
            self.cubic_ref = high if high_to_middle or high_to_low else low
            new_high = low if high_to_low else (
                new if high_to_middle else high)
            if not high_to_middle:
                self.low = new
            self.high = new_high
            self.failed = ((last or (self.too_small and self.safe.t > 0.0))
                           and not self.done)
        self.cur, self.grad_cur = new, grad
        self.count += 1
        if self.failed and (self.safe.t > 0.0 or np.isinf(dec)):
            self.cur, self.grad_cur = self.safe, self.grad_safe

    def result(self):
        return self.cur.t, self.cur.value, self.grad_cur


class ZoomLBFGSLanes:
    """optax.lbfgs(memory_size) over N lanes of flat vectors: the L-BFGS
    direction with a scaled-identity initial preconditioner, per lane,
    then each lane's zoom line search.

    ``step(x, value_and_grad)`` makes one iteration of every lane and
    returns (new x (N, n), the N values at x). ``value_and_grad(xs,
    lanes)`` evaluates the lanes listed in ``lanes`` at the rows of xs
    (len(lanes), n) and returns their values (k,) and gradients (k, n).
    ``linesearch_steps[i]`` lists lane i's trial points per iteration,
    ``evals[i]`` counts the evaluations of lane i (as its single run
    counts them) and ``calls`` the batched calls."""

    def __init__(self, lanes: int, n: int, memory_size: int, device=None,
                 dtype=torch.float32):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.lanes, self.m = lanes, memory_size
        self.count = 0
        self.dw = torch.zeros(lanes, memory_size, n, dtype=dtype,
                              device=device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(lanes, memory_size, dtype=dtype,
                               device=device)
        self.params = self.updates = None
        self.values, self.grad = None, None
        self.linesearch_steps: list[list[int]] = [[] for _ in range(lanes)]
        self.evals = [0] * lanes
        self.calls = 0

    def _direction(self, x, g):
        """scale_by_lbfgs per lane: admit (x - x_prev, g - g_prev), then
        the two-loop product P g, with P's initial scale y.s / y.y
        (min(1, 1/||g||) at the first iteration)."""
        m, k = self.m, self.count
        if k > 0:
            dp, du = x - self.params, g - self.updates
            vd = _dot(du, dp)
            den = _dot(du, du)
            prev = (k - 1) % m
            self.dw[:, prev], self.du[:, prev] = dp, du
            self.rho[:, prev] = torch.where(vd == 0.0, 0.0, 1.0 / vd)
            scale = torch.where(den > 0.0, vd / den, 1.0)
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1),
                                max=1.0)
        order = [(k % m + j) % m for j in range(m)]
        vec, alphas = g, [None] * m
        for j in reversed(range(m)):
            i = order[j]
            alphas[j] = self.rho[:, i] * _dot(self.dw[:, i], vec)
            vec = vec + _lane_col(-alphas[j]) * self.du[:, i]
        vec = _lane_col(scale) * vec
        for j in range(m):
            i = order[j]
            beta = self.rho[:, i] * _dot(self.du[:, i], vec)
            vec = vec + _lane_col(alphas[j] - beta) * self.dw[:, i]
        self.params, self.updates = x, g
        self.count += 1
        return vec

    def _evaluate(self, xs, lanes, value_and_grad):
        self.calls += 1
        for i in lanes:
            self.evals[i] += 1
        return value_and_grad(xs, lanes)

    def step(self, x, value_and_grad):
        every = list(range(self.lanes))
        # a lane evaluates at x only where it holds no finite value of its
        # accepted trial (optax.value_and_grad_from_state)
        need = [i for i in every
                if self.values is None or not math.isfinite(self.values[i])]
        values, g = list(self.values or [None] * self.lanes), self.grad
        if need:
            v, gn = self._evaluate(x if len(need) == self.lanes else x[need],
                                   need, value_and_grad)
            g = gn if len(need) == self.lanes else g.index_copy(
                0, torch.tensor(need, device=g.device), gn)
        u = -self._direction(x, g)
        read = torch.cat([v.double(), _dot(u, g).double()] if need
                         else [_dot(u, g).double()]).tolist()
        for j, i in enumerate(need):
            values[i] = read[j]
        slopes = read[len(need):]
        searches = [ZoomSearch(values[i], slopes[i], g[i]) for i in every]
        while True:
            active = [i for i in every if not searches[i].finished]
            if not active:
                break
            ts = [searches[i].propose() for i in active]
            xa, ua = ((x, u) if len(active) == self.lanes
                      else (x[active], u[active]))
            t = torch.tensor(ts, dtype=torch.float64).to(x.device, x.dtype)
            v, gt = self._evaluate(xa + ua * _lane_col(t), active,
                                   value_and_grad)
            vs, ss = torch.stack([v.double(), _dot(gt, ua).double()]
                                 ).tolist()
            for j, i in enumerate(active):
                searches[i].accept(ts[j], vs[j], ss[j], gt[j])
        chosen = [s.result() for s in searches]
        for i, s in enumerate(searches):
            self.linesearch_steps[i].append(s.count)
        self.values = [float(c[1]) for c in chosen]
        self.grad = torch.stack([c[2] for c in chosen])
        t = torch.tensor([c[0] for c in chosen], dtype=torch.float64)
        return x + u * _lane_col(t.to(x.device, x.dtype)), values


def one_lane(value_and_grad):
    """A one-vector ``value_and_grad(x) -> (value, gradient)`` as the lane
    steppers call it: (xs (1, n), lanes) -> ((1,), (1, n))."""
    def lanes_of(xs, lanes):
        v, g = value_and_grad(xs[0])
        return v.reshape(1), g[None]
    return lanes_of


class ZoomLBFGS:
    """``ZoomLBFGSLanes`` of one lane. ``step(x, value_and_grad)`` makes
    one iteration over the n-vector x with ``value_and_grad(x) -> (value,
    gradient)`` and returns (new x, the value at x); ``linesearch_steps``
    lists each iteration's trial points and ``evals`` counts every
    value-and-gradient call."""

    def __init__(self, n: int, memory_size: int, device=None,
                 dtype=torch.float32):
        self.lanes = ZoomLBFGSLanes(1, n, memory_size, device, dtype)

    @property
    def linesearch_steps(self) -> list[int]:
        return self.lanes.linesearch_steps[0]

    @property
    def evals(self) -> int:
        return self.lanes.evals[0]

    def step(self, x, value_and_grad):
        xs, values = self.lanes.step(x[None], one_lane(value_and_grad))
        return xs[0], values[0]
