"""SRGAN checkpoints: .pth files in the reference's naming and the port's
own training state.

Counterpart of ``tpusr/io/checkpoint.py`` (reference utils/common.py:
11-18, 46-60). A generator or discriminator .pth written by the reference,
by tpusr's ``export_torch_generator`` / ``export_torch_discriminator`` +
``save_torch_pth`` or by the port's own export loads here, and the port's
export loads in both of the others.

Reference names (models/GAN/generator.py) against the port's modules:
``residual_blocks.{i}.*`` is ``res{i}.*``, ``pixel_shuffle_blocks.{i}.*`` is
``ps{i}.*``, a PReLU's ``weight`` is its ``alpha``; convs keep OIHW and BNs
keep ``weight``/``bias``/``running_mean``/``running_var`` (the reference's
``num_batches_tracked`` is dropped on import and written as 0 on export).

The discriminator's ``convblocks.{i}.conv1`` / ``.bn1`` are the port's
``block{i}_conv`` / ``block{i}_bn``; the reference's ``dense1.weight`` is
(1024, C*H*W) in C, H, W order and its columns are permuted to and from the
port's NHWC flatten.

ESRGAN's RRDBNet (``import_esrgan_rrdbnet``, eval only): a state dict in
the names of ESRGAN's ``RRDBNet_arch.py`` or of BasicSR / Real-ESRGAN's
``rrdbnet_arch.py`` maps onto the port's ``RRDBNet``, whose dense-block
kernels are HWIO ``rrdb{i}.rdb{j}.conv{k}_kernel`` (the layout kernel C
reads) and whose other convs keep OIHW.

SwinIR (``import_swinir``, eval only): a state dict of the published
``network_swinir.py`` maps onto the port's ``SwinIR`` under the same names;
its ``relative_position_index`` and ``attn_mask`` buffers are dropped
(``infer_swinir_arch`` reads the widths from the shapes).

The full training state (both nets, both Adam states, the step) is an
orbax checkpoint directory in tpusr's tree (``save_train_state``: its
``GANTrainState`` as ``io.weights.export_flax_gan_state`` builds it,
written by ``io.orbax.write_tree``), for --checkpoint_every, --resume and
the ``{prefix}_state`` directories: tpusr's ``load_checkpoint`` restores
it, and ``load_train_state`` reads tpusr's (OCDBT, zstd) as well as the
port's own. The port's earlier ``torch.save`` state files still load.
"""

from __future__ import annotations

import os
import re

import torch

from tpusr_torch.engine.gan import set_adam_moments
from tpusr_torch.io.orbax import cast_like, read_tree, write_tree
from tpusr_torch.io.weights import export_flax_gan_state, load_flax_gan_state
from tpusr_torch.models.srgan import D_SCHEDULE, disc_feature_hw
from tpusr_torch.ops.window_attention import (WINDOW, relative_position_index,
                                              shifted_window_mask)

_CONV = ("weight", "bias")
_BN = ("weight", "bias", "running_mean", "running_var")


def _strip_ddp(sd: dict) -> dict:
    """'module.' prefix strip: load_model parity (utils/common.py:50-56)."""
    pattern = re.compile(r"^module\.")
    return {pattern.sub("", k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> dict:
    """A .pth state dict on the CPU, tensors only, DDP prefixes stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _strip_ddp(sd)


def infer_generator_arch(tree: dict) -> tuple[int, int]:
    """(residual_blocks_count, n_shuffles) of a generator checkpoint.

    Takes a reference state dict (``residual_blocks.{i}.*``,
    ``pixel_shuffle_blocks.{i}.*``) or one in tpusr's and the port's naming
    (``res{i}``, ``ps{i}``, at the top of a nested tree or as the first
    part of a dotted name).
    """
    keys = list(tree.keys())
    if any(k.startswith(("residual_blocks.", "pixel_shuffle_blocks."))
           for k in keys):  # reference state dict
        rb = {int(k.split(".")[1]) for k in keys
              if k.startswith("residual_blocks.")}
        ps = {int(k.split(".")[1]) for k in keys
              if k.startswith("pixel_shuffle_blocks.")}
    else:
        heads = {k.split(".")[0] for k in keys}
        rb = {int(h[3:]) for h in heads if h.startswith("res")
              and h[3:].isdigit()}
        ps = {int(h[2:]) for h in heads if h.startswith("ps")
              and h[2:].isdigit()}
    if not rb or not ps:
        raise ValueError(
            f"not a generator checkpoint (no residual/shuffle blocks found "
            f"among {sorted(keys)[:8]}...)")
    return max(rb) + 1, max(ps) + 1


def _name_pairs(residual_blocks_count: int, n_shuffles: int):
    """(reference name, port name) of every generator tensor, in order."""
    pairs = []

    def put(ref, port, leaves):
        pairs.extend((f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in leaves)

    put("conv1", "conv1", _CONV)
    pairs.append(("prelu1.weight", "prelu1.alpha"))
    for i in range(residual_blocks_count):
        ref, port = f"residual_blocks.{i}", f"res{i}"
        put(f"{ref}.conv1", f"{port}.conv1", _CONV)
        put(f"{ref}.bn1", f"{port}.bn1", _BN)
        pairs.append((f"{ref}.prelu1.weight", f"{port}.prelu1.alpha"))
        put(f"{ref}.conv2", f"{port}.conv2", _CONV)
        put(f"{ref}.bn2", f"{port}.bn2", _BN)
    put("conv2", "conv2", _CONV)
    put("bn1", "bn1", _BN)
    for i in range(n_shuffles):
        ref, port = f"pixel_shuffle_blocks.{i}", f"ps{i}"
        put(f"{ref}.conv1", f"{port}.conv1", _CONV)
        pairs.append((f"{ref}.prelu1.weight", f"{port}.prelu1.alpha"))
    put("conv3", "conv3", _CONV)
    return pairs


def import_torch_generator(sd: dict, residual_blocks_count: int = 16,
                           n_shuffles: int = 3) -> dict:
    """Reference Generator state dict -> the port's Generator state dict
    (f32 CPU tensors), for ``Generator.load_state_dict``. Raises KeyError on
    a missing reference key."""
    return {port: torch.as_tensor(sd[ref]).to(torch.float32)
            for ref, port in _name_pairs(residual_blocks_count, n_shuffles)}


def export_torch_generator(state: dict, residual_blocks_count: int = 16,
                           n_shuffles: int = 3) -> dict:
    """The port's Generator state dict -> the reference-named one, f32 CPU
    tensors (``save_torch_pth`` writes it as a .pth the reference's
    load_model accepts)."""
    sd = {ref: state[port].detach().to("cpu", torch.float32)
          for ref, port in _name_pairs(residual_blocks_count, n_shuffles)}
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)
    return sd


# the published RRDBNet's names per source, against the port's: dense-block
# convs, the conv after the trunk, the x2 stages' convs, the HR conv
_RRDB_NAMES = {
    "esrgan": {"block": "RRDB_trunk.{i}.RDB{j}.conv{k}",
               "trunk_conv": "trunk_conv", "upconv": "upconv{n}",
               "conv_hr": "HRconv"},
    "basicsr": {"block": "body.{i}.rdb{j}.conv{k}",
                "trunk_conv": "conv_body", "upconv": "conv_up{n}",
                "conv_hr": "conv_hr"},
}


def _unwrap_params(sd: dict) -> dict:
    """BasicSR's .pth wraps the state dict in ``params_ema`` or
    ``params``; Real-ESRGAN's inference prefers the former."""
    for key in ("params_ema", "params"):
        if key in sd and isinstance(sd[key], dict):
            return sd[key]
    return sd


def _rrdb_source(sd: dict) -> str:
    for source, names in _RRDB_NAMES.items():
        if any(k.startswith(_trunk_prefix(names)) for k in sd):
            return source
    raise ValueError(f"not an RRDBNet state dict (no RRDB_trunk.* or "
                     f"body.* among {sorted(sd)[:8]}...)")


def _trunk_prefix(names: dict) -> str:
    return names["block"].split(".")[0] + "."


def infer_rrdb_arch(sd: dict) -> tuple[int, int]:
    """(RRDB blocks, x2 stages) of an RRDBNet state dict in ESRGAN's or
    BasicSR's names (``params_ema`` / ``params`` unwrapped); ValueError on
    any other state dict."""
    sd = _unwrap_params(sd)
    names = _RRDB_NAMES[_rrdb_source(sd)]
    trunk = _trunk_prefix(names)
    up = re.escape(names["upconv"].removesuffix("{n}")) + r"\d+\.weight"
    blocks = {int(k.split(".")[1]) for k in sd if k.startswith(trunk)}
    return max(blocks) + 1, sum(bool(re.fullmatch(up, k)) for k in sd)


def _rrdb_name_pairs(source: str, nb: int, n_up: int):
    """(published name, port name, HWIO) of every RRDBNet tensor."""
    names = _RRDB_NAMES[source]
    pairs = []

    def put(ref, port, hwio=False):
        pairs.append((f"{ref}.weight",
                      f"{port}_kernel" if hwio else f"{port}.weight", hwio))
        pairs.append((f"{ref}.bias",
                      f"{port}_bias" if hwio else f"{port}.bias", False))

    put("conv_first", "conv_first")
    for i in range(nb):
        for j in range(1, 4):
            for k in range(1, 6):
                put(names["block"].format(i=i, j=j, k=k),
                    f"rrdb{i}.rdb{j}.conv{k}", hwio=True)
    put(names["trunk_conv"], "trunk_conv")
    for n in range(1, n_up + 1):
        put(names["upconv"].format(n=n), f"upconv{n}")
    put(names["conv_hr"], "conv_hr")
    put("conv_last", "conv_last")
    return pairs


def import_esrgan_rrdbnet(sd: dict, nb: int, n_up: int = 2) -> dict:
    """A published RRDBNet state dict -> the port's ``RRDBNet`` state dict
    (f32, on the tensors' own device), for ``load_state_dict``.

    Takes ESRGAN's names (``conv_first``, ``RRDB_trunk.{i}.RDB{j}.
    conv{k}``, ``trunk_conv``, ``upconv{n}``, ``HRconv``, ``conv_last``)
    or BasicSR / Real-ESRGAN's (``body.{i}.rdb{j}.conv{k}``,
    ``conv_body``, ``conv_up{n}``, ``conv_hr``, ``conv_last``), optionally
    under a top-level ``params_ema`` / ``params``; ``nb`` RRDBs, ``n_up``
    x2 stages (2: x4, as published). The dense-block kernels go from OIHW
    to HWIO. A missing or an extra key raises KeyError naming it."""
    sd = _unwrap_params(sd)
    pairs = _rrdb_name_pairs(_rrdb_source(sd), nb, n_up)
    missing = [ref for ref, _, _ in pairs if ref not in sd]
    extra = sorted(set(sd) - {ref for ref, _, _ in pairs})
    if missing or extra:
        raise KeyError(f"RRDBNet state dict does not fit nb={nb}, "
                       f"n_up={n_up}: missing {missing[:4]}, extra "
                       f"{extra[:4]}")
    out = {}
    for ref, port, hwio in pairs:
        t = torch.as_tensor(sd[ref]).to(torch.float32)
        out[port] = t.permute(2, 3, 1, 0).contiguous() if hwio else t
    return out


# SwinIR's published buffers, which the port recomputes from the shapes
_SWINIR_BUFFERS = ("attn_mask", "relative_position_index")
_SWINIR_BLOCK = re.compile(r"layers\.(\d+)\.residual_group\.blocks\.(\d+)\.")


def infer_swinir_arch(sd: dict) -> dict:
    """SwinIR's constructor arguments (``upscale``, ``in_chans``,
    ``embed_dim``, ``depths``, ``num_heads``, ``mlp_ratio``, ``num_feat``)
    read from a published state dict with the nearest+conv upsampler and
    the '1conv' residual connection (``params_ema`` / ``params``
    unwrapped); ValueError on any other state dict or a window other than
    the kernel's 8."""
    sd = _unwrap_params(sd)
    blocks: dict[int, set] = {}
    for k in sd:
        m = _SWINIR_BLOCK.match(k)
        if m:
            blocks.setdefault(int(m[1]), set()).add(int(m[2]))
    if not blocks or "conv_first.weight" not in sd \
            or "conv_up1.weight" not in sd or "layers.0.conv.weight" not in sd:
        raise ValueError(f"not a SwinIR state dict with the nearest+conv "
                         f"upsampler and a 1conv residual connection (among "
                         f"{sorted(sd)[:8]}...)")
    groups = range(max(blocks) + 1)
    tables = [sd[f"layers.{i}.residual_group.blocks.0.attn."
                 f"relative_position_bias_table"] for i in groups]
    if any(t.shape[0] != (2 * WINDOW - 1) ** 2 for t in tables):
        raise ValueError(f"SwinIR state dict of another window than "
                         f"{WINDOW}: bias tables of {tables[0].shape[0]} rows")
    embed, in_chans = sd["conv_first.weight"].shape[:2]
    hidden = sd["layers.0.residual_group.blocks.0.mlp.fc1.weight"].shape[0]
    return {"upscale": 4 if "conv_up2.weight" in sd else 2,
            "in_chans": in_chans, "embed_dim": embed,
            "depths": tuple(max(blocks[i]) + 1 for i in groups),
            "num_heads": tuple(t.shape[1] for t in tables),
            "mlp_ratio": hidden / embed,
            "num_feat": sd["conv_before_upsample.0.weight"].shape[0]}


def import_swinir(sd: dict) -> dict:
    """A published SwinIR state dict (bare or under ``params_ema`` /
    ``params``) -> the port's ``SwinIR`` state dict (f32, the same names),
    for ``load_state_dict``. Its ``relative_position_index`` and
    ``attn_mask`` buffers are dropped: the port computes both from the
    shapes (the window kernel in its addressing), and each buffer the file
    carries is held to that recomputation (ValueError if it differs)."""
    sd = _unwrap_params(sd)
    out = {}
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf not in _SWINIR_BUFFERS:
            out[k] = torch.as_tensor(v).to(torch.float32)
        elif leaf == "relative_position_index":
            if not torch.equal(v.cpu().long(), relative_position_index()):
                raise ValueError(f"{k} is not the published index")
        else:  # the mask at the image size the model was built for
            side = round(v.shape[0] ** 0.5) * WINDOW
            want = shifted_window_mask((side, side), WINDOW, WINDOW // 2)
            if not torch.equal(v.cpu().float(), want):
                raise ValueError(f"{k} is not the published shifted-window "
                                 f"mask")
    return out


def _disc_name_pairs():
    pairs = [(f"conv.{leaf}", f"conv.{leaf}") for leaf in _CONV]
    for i in range(len(D_SCHEDULE)):
        ref = f"convblocks.{i}"
        pairs += [(f"{ref}.conv1.{leaf}", f"block{i}_conv.{leaf}")
                  for leaf in _CONV]
        pairs += [(f"{ref}.bn1.{leaf}", f"block{i}_bn.{leaf}")
                  for leaf in _BN]
    return pairs + [(f"dense{k}.{leaf}", f"dense{k}.{leaf}")
                    for k in (1, 2) for leaf in _CONV]


def _dense1_order(w: torch.Tensor, hr_patch: int, to_nhwc: bool):
    hw, c = disc_feature_hw(hr_patch), D_SCHEDULE[-1][0]
    if to_nhwc:  # columns C, H, W -> H, W, C
        return w.reshape(-1, c, hw, hw).permute(0, 2, 3, 1).reshape(
            w.shape[0], -1)
    return w.reshape(-1, hw, hw, c).permute(0, 3, 1, 2).reshape(
        w.shape[0], -1)


def import_torch_discriminator(sd: dict, hr_patch: int = 192) -> dict:
    """Reference Discriminator state dict -> the port's Discriminator state
    dict (f32 CPU tensors), dense1's columns permuted from the reference's
    C, H, W flatten to H, W, C (discriminator.py:54)."""
    out = {port: torch.as_tensor(sd[ref]).to(torch.float32)
           for ref, port in _disc_name_pairs()}
    out["dense1.weight"] = _dense1_order(out["dense1.weight"], hr_patch,
                                         True).contiguous()
    return out


def export_torch_discriminator(state: dict, hr_patch: int = 192) -> dict:
    """The port's Discriminator state dict -> the reference-named one, f32
    CPU tensors (bf16-stored weights widened), dense1 back in C, H, W
    order (save_model(pre_trained_D), train_GAN.py:188)."""
    sd = {ref: state[port].detach().to("cpu", torch.float32)
          for ref, port in _disc_name_pairs()}
    sd["dense1.weight"] = _dense1_order(sd["dense1.weight"], hr_patch,
                                        False).contiguous()
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)
    return sd


def save_torch_pth(sd: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: torch.as_tensor(v).contiguous() for k, v in sd.items()},
               path)
    print(f"Model saved to {path}")


def save_train_state(path: str, state) -> None:
    """The whole GANTrainState as an orbax checkpoint directory in tpusr's
    tree (both nets, their statistics, both Adam states, the step), which
    tpusr's ``load_checkpoint`` restores with or without a target."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_tree(path, export_flax_gan_state(state))
    print(f"State saved to {path}")


def load_train_state(path: str, state):
    """Restore a training state into ``state`` (built for the same
    configuration) in place and return it: an orbax checkpoint directory
    written by tpusr or by ``save_train_state``, or a state file of the
    port's earlier ``torch.save`` format. Leaves are cast to the target's
    dtypes (tpusr/io/checkpoint.py:49-58), so a state written with f32 D
    moments or weights resumes into bf16 storage and back. A directory
    that is not an orbax checkpoint, or whose tree does not fit, raises."""
    if os.path.isdir(path):
        tree = cast_like(read_tree(path), export_flax_gan_state(state))
        load_flax_gan_state(state, tree)
        return state
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(saved, dict)
            and saved.get("format") == "tpusr_torch GANTrainState"):
        raise ValueError(f"{path} is not a tpusr_torch training state")
    with torch.no_grad():
        for net, key in ((state.G, "G"), (state.D, "D")):
            own = net.state_dict()
            if set(own) != set(saved[key]):
                raise KeyError(f"{path}: {key} does not fit this model")
            for k, v in saved[key].items():
                own[k].copy_(v)
    for opt, key in ((state.opt_G, "opt_G"), (state.opt_D, "opt_D")):
        o = saved[key]
        set_adam_moments(opt, o["count"], o["m"], o["v"])
    state.step = int(saved["step"])
    return state
