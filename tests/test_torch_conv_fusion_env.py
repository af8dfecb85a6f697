"""TPUSR_CONV_FUSION in tpusr_torch, as tpusr reads it.

tpusr reads the variable once at import as the default of every 'auto'
fusion field (tpusr/models/layers.py:79-85). The port does the same in
``tpusr_torch.models.layers.fusion_mode``. Each case runs in a fresh
process with the variable set, since it is read at import:

* 'off': the default SkipNet, SRGAN Generator (through
  ``generator_forward``, which fuses the eval forward by default) and
  RRDBNet (nf 64 / gc 32, kernel C's width) call neither
  ``fused_conv3x3`` nor ``dense_block`` (on the CPU the wrappers count no
  launch, so the child counts the calls), and their outputs equal those
  of the nets built with an explicit 'off';
* unset: the same nets do call them (the control);
* 'interpret' (tpusr's Pallas-only mode) and an unknown value raise
  ValueError naming the values the port takes.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpusr_torch.models.layers import fusion_mode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json
import torch
from tpusr_torch.engine.gan import (GANTrainConfig, build_generator,
                                    generator_forward)
from tpusr_torch.models import layers, rrdb
from tpusr_torch.models.rrdb import RRDBNet
from tpusr_torch.models.skip import build_dip_net

torch.set_num_threads(1)
calls = {"fused_conv3x3": 0, "dense_block": 0}


def counted(name, fn):
    def wrapper(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return wrapper


layers.fused_conv3x3 = counted("fused_conv3x3", layers.fused_conv3x3)
rrdb.fused_conv3x3 = counted("fused_conv3x3", rrdb.fused_conv3x3)
rrdb.dense_block = counted("dense_block", rrdb.dense_block)


def nets(fusion):
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1, 4, 16, 16, generator=gen)
    skip = build_dip_net(input_depth=4, skip_n33d=8, skip_n33u=8, skip_n11=2,
                         num_scales=2, conv_fusion=fusion, generator=gen)
    out = {"skip": skip(x)}
    cfg = GANTrainConfig(factor=4, residual_blocks_count=1,
                         conv_fusion=fusion)
    g = build_generator(cfg, "cpu", gen)
    out["generator"] = generator_forward(g, torch.rand(1, 6, 6, 3,
                                                       generator=gen), cfg)
    r = RRDBNet(nf=64, nb=1, gc=32, scale=2, fusion=fusion, device="cpu",
                generator=gen)
    out["rrdb"] = r(torch.rand(1, 3, 6, 6, generator=gen))
    return {k: v.detach() for k, v in out.items()}


with torch.no_grad():
    default = nets("auto")
    used = dict(calls)
    explicit = nets("off")
print(json.dumps({"calls": used, "equal": {
    k: bool(torch.equal(default[k], explicit[k])) for k in default}}))
"""


def _child(value):
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop("TPUSR_CONV_FUSION", None)
    if value is not None:
        env["TPUSR_CONV_FUSION"] = value
    return subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_env_off_runs_every_default_net_unfused():
    run = _child("off")
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.splitlines()[-1])
    assert got["calls"] == {"fused_conv3x3": 0, "dense_block": 0}
    assert got["equal"] == {"skip": True, "generator": True, "rrdb": True}


def test_env_unset_fuses_the_default_nets():
    run = _child(None)
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.splitlines()[-1])
    # SkipNet: down/up convs at 2 scales; Generator: its 3x3 convs; RRDB:
    # three dense blocks (kernel C) and trunk/up/hr convs (kernel A)
    assert got["calls"]["fused_conv3x3"] > 0
    assert got["calls"]["dense_block"] == 3


@pytest.mark.parametrize("value", ["interpret", "pallas"])
def test_env_value_the_port_lacks_raises(value):
    run = _child(value)
    assert run.returncode != 0
    assert "ValueError" in run.stderr
    assert f"conv fusion '{value}' (TPUSR_CONV_FUSION) not in auto/off" in (
        run.stderr)


@pytest.mark.parametrize("value", ["interpret", "pallas"])
def test_explicit_value_the_port_lacks_raises(value):
    from tpusr_torch.models.layers import Conv
    from tpusr_torch.models.rrdb import RRDBNet
    from tpusr_torch.models.skip import build_dip_net

    match = f"conv fusion '{value}' not in auto/off"
    with pytest.raises(ValueError, match=match):
        fusion_mode(value)
    with pytest.raises(ValueError, match=match):
        Conv(4, 4, 3, fusion=value)
    with pytest.raises(ValueError, match=match):
        build_dip_net(input_depth=4, skip_n33d=8, skip_n33u=8, skip_n11=2,
                      num_scales=2, conv_fusion=value)
    with pytest.raises(ValueError, match=match):
        RRDBNet(nf=8, nb=1, gc=4, fusion=value, device="cpu")
    assert fusion_mode("off") == "off"
