"""The comparisons that decide ``correct``.

Training (each DIP call is one training job of a fresh net): the first
three steps of the program are held to the plain reference's from the
same seed. DIP records them inside every call of the window through
PyTorch's global optimizer-step hooks; SRGAN training reads them from
the state between two calls of its trainer in set-up, and holds the
window's own first steps to the reference started from a snapshot of the
state the window starts from (``drivers/srgan_train.py``). The readings
(each cell's file says which of them it compares):

* ``loss_gap``: the largest relative gap of a loss of the first step.
  The losses of steps 2 and 3 are not read: Adam's first step moves every
  weight by about lr times its gradient's sign, so a rounding that flips
  the sign of a gradient near zero moves that weight by 2 lr, and the
  later losses part by per cents in sound runs and in the control alike.
* ``grad_gap``: the gradient that the optimizer got at step 1, worked out
  from its first moment after the step (m1 = (1 - beta1) g1); per leaf the
  gap between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf; the worst
  leaf.
* ``grad_gap_median``: the same of the median leaf, over the leaves that
  move (below): steady where one small leaf's gradient is a sum that
  cancels, as a PReLU slope's is in bf16.
* ``net_grad_gap``: per net (the leaves named ``<net>.``, one net where
  the names give none), the relative gap between the norm of the net's
  whole first gradient and the reference's; the worst net. Half of a
  batch left out moves a discriminator's by a fifth and more, where
  bf16's rounding moves it by under a hundredth.
* ``change_gap``: each leaf's change over the three steps, measured the
  same way, of the median leaf that moves. Leaves whose reference
  gradient is under a thousandth of the median leaf's are left out (a
  conv bias under a BatchNorm, nought but for rounding, which Adam turns
  into steps of lr). The worst leaf's reads up to a tenth in sound runs
  and no more in the control (the sign flips above, compounded over the
  steps, in a small BatchNorm leaf); the median leaf's is steady, and a
  state left unchanged reads 1.

Images (eval): per sampled output the largest absolute gap to the
reference (``max_gap``) and the root-mean-square gap over the reference's
root-mean-square (``rms_gap``); the worst sample.
"""

from __future__ import annotations

import statistics

import torch

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is below this share
# of the median leaf's do not count as moving


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _leaf_gaps(prog: dict, ref: dict, keys) -> list[float]:
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k]
                                                         for k in keys})
    med = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]


def _nets(keys) -> dict:
    """Leaves grouped by net: 'G.x' and 'D.x' by their prefix."""
    nets = {}
    for k in keys:
        net = k.split(".")[0] if k[:2] in ("G.", "D.") else ""
        nets.setdefault(net, []).append(k)
    return nets


def _net_gap(prog: dict, ref: dict, keys) -> float:
    def norm(t):
        return float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t[k].double()) for k in keys])))
    return abs(norm(prog) - norm(ref)) / norm(ref)


def loss_gaps(prog: list[float], ref: list[float]) -> float:
    """The largest relative gap between two lists of losses."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref, strict=True))


def training_gaps(prog: dict, ref: dict) -> dict:
    """prog and ref: {'grad1': {leaf: t}, 'change': {leaf: t}} over the
    same leaves, and optionally 'loss' (the first step's losses)."""
    keys = sorted(ref["grad1"])
    if sorted(prog["grad1"]) != keys:
        raise ValueError("the program's leaves are not the reference's")
    gnorm = _norms(ref["grad1"])
    floor = GRAD_FLOOR * statistics.median(gnorm.values())
    moved = [k for k in keys if gnorm[k] >= floor]
    out = {"loss_gap": loss_gaps(prog["loss"], ref["loss"])} \
        if "loss" in prog else {}
    return {**out,
            "grad_gap": max(_leaf_gaps(prog["grad1"], ref["grad1"], keys)),
            "net_grad_gap": max(_net_gap(prog["grad1"], ref["grad1"], ks)
                                for ks in _nets(keys).values()),
            "grad_gap_median": statistics.median(
                _leaf_gaps(prog["grad1"], ref["grad1"], moved)),
            "change_gap": statistics.median(
                _leaf_gaps(prog["change"], ref["change"], moved))}


def image_gaps(out: torch.Tensor, ref: torch.Tensor) -> dict:
    diff = (out.double() - ref.double())
    rms_ref = float(ref.double().square().mean().sqrt())
    return {"max_gap": float(diff.abs().max()),
            "rms_gap": float(diff.square().mean().sqrt()) / rms_ref}


def worst(readings: list[dict]) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}
