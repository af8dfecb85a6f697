"""Weight bridge: JAX (flax) variables -> the port's SkipNet, RRDBNet,
SRGAN Generator and Discriminator, and a whole SRGAN training state; and
back, for the SRGAN nets and training state (``export_flax_*``), so the
port writes the tree tpusr's orbax checkpoints hold.

The JAX package keeps conv kernels HWIO and BatchNorm params as
``scale``/``bias`` with running stats ``mean``/``var`` in a separate
``batch_stats`` collection; the port keeps OIHW ``weight`` tensors and
``running_mean``/``running_var`` buffers under the same module names. The
tests feed both packages the same weights through this bridge; the port
itself never needs JAX (the variables arrive as nested dicts of arrays or
tensors: io/orbax.py's ``read_tree`` gives tensors, bf16 ones included).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from tpusr_torch.engine.gan import adam_moments, set_adam_moments

# (collection, flax leaf) -> (torch name, convert)
_LEAVES = {
    ("params", "kernel"): ("weight", lambda a: a.transpose(3, 2, 0, 1)),
    ("params", "bias"): ("bias", lambda a: a),
    ("params", "scale"): ("weight", lambda a: a),
    ("batch_stats", "mean"): ("running_mean", lambda a: a),
    ("batch_stats", "var"): ("running_var", lambda a: a),
}


def _np32(val) -> np.ndarray:
    """A leaf as f32 numpy: a tensor (bf16 too) or anything np.asarray
    takes."""
    if isinstance(val, torch.Tensor):
        return val.detach().to("cpu", torch.float32).numpy()
    return np.asarray(val, np.float32)


def _flatten(collection: str, tree: Mapping) -> dict[str, np.ndarray]:
    flat = {}
    for mod_name, leaves in tree.items():
        for leaf, arr in leaves.items():
            key = (collection, leaf)
            if key not in _LEAVES:
                raise KeyError(f"unexpected {collection} leaf "
                               f"{mod_name}/{leaf}")
            name, convert = _LEAVES[key]
            flat[f"{mod_name}.{name}"] = convert(_np32(arr))
    return flat


def load_flax_skipnet(module: nn.Module, params: Mapping,
                      batch_stats: Mapping) -> None:
    """Copy flax SkipNet variables into ``module`` in place.

    Conv kernels go HWIO -> OIHW (the 132-input SplitConv kernel keeps its
    [skip, trunk] channel order), BN scale/bias/mean/var go to
    weight/bias/running_mean/running_var. Raises on a missing or extra key
    and on a shape mismatch.
    """
    flat = _flatten("params", params)
    flat.update(_flatten("batch_stats", batch_stats))
    _copy_into(module, flat)


def _flatten_nested(tree: Mapping, prefix: str = "",
                    renames: Mapping[str, str] | None = None
                    ) -> dict[str, np.ndarray]:
    """Flax variables of any depth -> {dotted torch name: array}. ``kernel``
    (HWIO) becomes an OIHW ``weight``; a leaf named in ``renames`` takes the
    torch name given there; every other leaf keeps its name and layout
    (DenseBlock's ``conv{k}_kernel`` stay HWIO, as kernel C reads them)."""
    renames = renames or {}
    flat = {}
    for name, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flatten_nested(val, f"{prefix}{name}.", renames))
        elif name == "kernel":
            flat[f"{prefix}weight"] = _np32(val).transpose(3, 2, 0, 1)
        else:
            flat[f"{prefix}{renames.get(name, name)}"] = _np32(val)
    return flat


def _copy_into(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: missing {missing}, "
                       f"extra {extra}")
    for name, arr in flat.items():
        if tuple(state[name].shape) != arr.shape:
            raise ValueError(f"{name}: shape {arr.shape} does not fit "
                             f"{tuple(state[name].shape)}")
    with torch.no_grad():
        for name, arr in flat.items():
            state[name].copy_(torch.from_numpy(np.array(arr)))


def load_flax_rrdbnet(module: nn.Module, params: Mapping) -> None:
    """Copy flax RRDBNet params (``rrdb{i}/rdb{j}/conv{k}_kernel``,
    ``conv_first/kernel``, ...) into ``module`` in place. Conv kernels go
    HWIO -> OIHW; the dense blocks' own kernels stay HWIO. Raises on a
    missing or extra key and on a shape mismatch."""
    _copy_into(module, _flatten_nested(params))


def load_flax_generator(module: nn.Module, params: Mapping,
                        batch_stats: Mapping) -> None:
    """Copy flax SRGAN Generator variables (``res{i}/conv1/kernel``,
    ``res{i}/bn1/scale``, ``prelu1/alpha``, ``ps{i}/conv1/kernel``, ...;
    ``batch_stats`` ``.../mean`` and ``.../var``) into ``module`` in place.
    Conv kernels go HWIO -> OIHW, BN scale/mean/var go to weight/
    running_mean/running_var. Raises on a missing or extra key and on a
    shape mismatch."""
    flat = _flatten_nested(params, renames={"scale": "weight"})
    flat.update(_flatten_nested(batch_stats, renames={
        "mean": "running_mean", "var": "running_var"}))
    _copy_into(module, flat)


def _flat_discriminator(tree: Mapping) -> dict[str, np.ndarray]:
    """A flax Discriminator tree (params or an Adam moment tree of the same
    shape) -> {port name: array}: conv kernels HWIO -> OIHW, BN scale ->
    weight, dense{k}/Dense_0/kernel (in, out) -> dense{k}.weight (out,
    in)."""
    flat = {}
    for name, sub in tree.items():
        if name.startswith("dense"):
            sub = sub["Dense_0"]
            flat[f"{name}.weight"] = _np32(sub["kernel"]).T
            flat[f"{name}.bias"] = _np32(sub["bias"])
        else:
            flat.update(_flatten_nested({name: sub},
                                        renames={"scale": "weight"}))
    return flat


def load_flax_discriminator(module: nn.Module, params: Mapping,
                            batch_stats: Mapping) -> None:
    """Copy flax SRGAN Discriminator variables (``conv``, ``block{i}_conv``,
    ``block{i}_bn``, ``dense{1,2}/Dense_0``) into ``module`` in place,
    into its parameters' own dtypes (bf16-stored ones included). Raises on
    a missing or extra key and on a shape mismatch."""
    flat = _flat_discriminator(params)
    flat.update(_flatten_nested(batch_stats, renames={
        "mean": "running_mean", "var": "running_var"}))
    _copy_into(module, flat)


def _field(tree, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def load_flax_gan_state(state, jax_state) -> None:
    """Carry a tpusr GANTrainState (its leaves as numpy, or the tree
    ``io.orbax.read_tree`` reads from its checkpoint) into the port's
    GANTrainState (built for the same configuration) in place: both nets
    and their statistics, both Adam states (count, m, v, cast to the
    optimizers' storage) and the step."""
    load_flax_generator(state.G, _field(jax_state, "params_G"),
                        _field(jax_state, "stats_G"))
    load_flax_discriminator(state.D, _field(jax_state, "params_D"),
                            _field(jax_state, "stats_D"))
    for net, opt, tx, flat in (
            (state.G, state.opt_G, _field(jax_state, "opt_G"),
             lambda t: _flatten_nested(t, renames={"scale": "weight"})),
            (state.D, state.opt_D, _field(jax_state, "opt_D"),
             _flat_discriminator)):
        adam = tx[0]  # (ScaleByAdamState(count, mu, nu), EmptyState())
        mu, nu = flat(_field(adam, "mu")), flat(_field(adam, "nu"))
        names = [n for n, _ in net.named_parameters()]
        set_adam_moments(opt, int(np.asarray(_field(adam, "count"))),
                         [torch.from_numpy(np.array(mu[n])) for n in names],
                         [torch.from_numpy(np.array(nu[n])) for n in names])
    state.step = int(np.asarray(_field(jax_state, "step")))


def _to_flax(named: Iterable[tuple[str, torch.Tensor]]) -> dict:
    """(port name, tensor) pairs -> a flax tree, each tensor on the CPU in
    its own dtype: a 4-d ``weight`` becomes an HWIO ``kernel``, another
    ``weight`` a BatchNorm ``scale``, ``dense{k}.*`` moves under
    ``Dense_0`` with its (out, in) weight as an (in, out) kernel, running
    statistics become ``mean`` / ``var``."""
    tree: dict = {}
    for name, t in named:
        *mods, leaf = name.split(".")
        t = t.detach().to("cpu")
        if mods[0].startswith("dense"):
            mods.append("Dense_0")
            if leaf == "weight":
                leaf, t = "kernel", t.t()
        elif leaf == "weight":
            leaf, t = (("kernel", t.permute(2, 3, 1, 0)) if t.dim() == 4
                       else ("scale", t))
        else:
            leaf = {"running_mean": "mean", "running_var": "var"}.get(
                leaf, leaf)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t.contiguous().clone()
    return tree


def _export_net(module: nn.Module) -> tuple[dict, dict]:
    params = _to_flax(module.named_parameters())
    stats = _to_flax((n, b) for n, b in module.named_buffers()
                     if n.endswith(("running_mean", "running_var")))
    return params, stats


def export_flax_generator(module: nn.Module) -> tuple[dict, dict]:
    """The port's SRGAN Generator -> flax (params, batch_stats), the
    inverse of ``load_flax_generator``."""
    return _export_net(module)


def export_flax_discriminator(module: nn.Module) -> tuple[dict, dict]:
    """The port's Discriminator -> flax (params, batch_stats) in its
    parameters' own dtypes (bf16-stored leaves stay bf16), the inverse of
    ``load_flax_discriminator``."""
    return _export_net(module)


def _export_adam(net: nn.Module, opt) -> list:
    count, ms, vs = adam_moments(opt)
    names = [n for n, _ in net.named_parameters()]
    return [{"count": torch.tensor(count, dtype=torch.int32),
             "mu": _to_flax(zip(names, ms)), "nu": _to_flax(zip(names, vs))},
            None]  # optax's (ScaleByAdamState, EmptyState()); None on disk


def export_flax_gan_state(state) -> dict:
    """The port's GANTrainState as tpusr's GANTrainState tree, the inverse
    of ``load_flax_gan_state``: ``params_G``, ``stats_G``, ``params_D``,
    ``stats_D``, ``opt_G`` and ``opt_D`` as optax's ``(ScaleByAdamState(
    count, mu, nu), EmptyState())`` (a list whose second leaf is None, as
    orbax stores it), and ``step``; counts and step int32, every other leaf
    in the port's storage dtype (f32, or bf16 where d_params / d_moments
    say), which is tpusr's."""
    params_G, stats_G = export_flax_generator(state.G)
    params_D, stats_D = export_flax_discriminator(state.D)
    return {"params_G": params_G, "stats_G": stats_G,
            "params_D": params_D, "stats_D": stats_D,
            "opt_G": _export_adam(state.G, state.opt_G),
            "opt_D": _export_adam(state.D, state.opt_D),
            "step": torch.tensor(int(state.step), dtype=torch.int32)}
