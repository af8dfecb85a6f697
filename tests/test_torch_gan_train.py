"""tpusr_torch's SRGAN training step against tpusr's, on the CPU.

Both packages start from the same weights and Adam states (tpusr's
``create_gan_state``, carried across by ``load_flax_gan_state``) and take
the same three batches at factor 4, batch 2, hr_patch 32, 2 residual
blocks; after the first and the third step the losses, both nets'
parameters and running statistics, and both Adam states are compared.

At random init both nets' gradients through the discriminator's fake
group are ill-conditioned: its BatchNorm channels are nearly flat
(variance 1.5 % of the squared mean after block0_conv), and the port's own
f32 and f64 runs of D's gradient differ by 3.5e-3 of each leaf's largest
entry. Adam's first steps move each element by about lr times the sign of
its gradient, so an element whose gradient sign f32 cannot fix moves up
to 2 lr apart in the two packages. Hence: the steps run at lr 1e-6, which
keeps 3 steps of that under the 1e-5 parameter tolerance; the losses are
held to 1e-4 relative (measured: 1.5e-5 at step 3); the update itself is
held by its direction, which agrees on at least 95 % of each f32 leaf's
elements, or on all but 4 (measured: 4 of 64 at worst), and by the Adam
moments (the
gradients' EMAs), within 5e-2 of each net's moment vector in L2
(measured: 2.2e-2 at worst, 1e-5 where the adversarial gradient is
detached). Conv biases that a BatchNorm follows have a zero gradient in
exact arithmetic and rounding noise in both packages: they are held to
2 lr per step only. bf16-stored leaves (d_params='bf16') are held within
one bf16 ulp, plus the 2 lr a step of an element too small for its ulp to
hide a sign flip. Running statistics follow D's and G's forwards on the
updated weights: 1e-4 relative, 1e-5 absolute.
tpusr's step runs under one test-side jit on a strongly typed state (its
own jit recompiles when a weak type flips), and its init under one jit.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.engine import gan as jg
from tpusr.engine import losses as JL
from tpusr_torch.engine import gan as pg
from tpusr_torch.io.weights import (_flat_discriminator, _flatten_nested,
                                    load_flax_gan_state)

LR = 1e-6
SHAPE = dict(factor=4, batch_size=2, hr_patch=32, residual_blocks_count=2)
BN_FED_BIAS = re.compile(r"^(G\.res\d+\.conv[12]|G\.conv2|D\.block\d+_conv)"
                         r"\.bias$")
STATS = {"mean": "running_mean", "var": "running_var"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _strong(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), tree)


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [(rng.random((2, 8, 8, 3)).astype(np.float32),
             rng.random((2, 32, 32, 3)).astype(np.float32) * 2 - 1)
            for _ in range(n)]


def _jax_flat(js):
    jn = jax.tree.map(np.asarray, js)
    out = {f"G.{k}": v for k, v in _flatten_nested(
        jn.params_G, renames={"scale": "weight"}).items()}
    out.update({f"G.{k}": v for k, v in _flatten_nested(
        jn.stats_G, renames=STATS).items()})
    out.update({f"D.{k}": v for k, v in _flat_discriminator(
        jn.params_D).items()})
    out.update({f"D.{k}": v for k, v in _flatten_nested(
        jn.stats_D, renames=STATS).items()})
    moments = {}
    for net, tx, flat in (("G", jn.opt_G, lambda t: _flatten_nested(
            t, renames={"scale": "weight"})), ("D", jn.opt_D,
                                               _flat_discriminator)):
        for which, tree in (("m", tx[0].mu), ("v", tx[0].nu)):
            moments.update({f"{which}.{net}.{k}": v
                            for k, v in flat(tree).items()})
    return out, moments, int(jn.opt_D[0].count)


def _port_flat(ps):
    out, moments = {}, {}
    for net, mod, opt in (("G", ps.G, ps.opt_G), ("D", ps.D, ps.opt_D)):
        out.update({f"{net}.{k}": v.detach().float().numpy().copy()
                    for k, v in mod.state_dict().items()})
        count, ms, vs = pg.adam_moments(opt)
        for (k, _), m, v in zip(mod.named_parameters(), ms, vs):
            moments[f"m.{net}.{k}"] = m.float().numpy().copy()
            moments[f"v.{net}.{k}"] = v.float().numpy().copy()
    bf16 = {f"D.{k}" for k, p in ps.D.named_parameters()
            if p.dtype == torch.bfloat16}
    return out, moments, count, bf16


def _bf16_ulp(a, b):
    mag = np.maximum(np.abs(a), np.abs(b))
    return np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)


def _compare(ps, js, start, steps):
    got, got_m, count, bf16 = _port_flat(ps)
    want, want_m, want_count = _jax_flat(js)
    assert count == want_count == steps
    assert set(got) == set(want)
    for k, a in got.items():
        b = want[k]
        if k in bf16:
            assert np.all(np.abs(a - b)
                          <= _bf16_ulp(a, b) + 2 * LR * steps), k
        elif BN_FED_BIAS.match(k):
            assert np.abs(a - b).max() <= 2 * LR * steps, k
        elif "running" in k:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        if k in start and k not in bf16 and not BN_FED_BIAS.match(k) \
                and "running" not in k:
            flips = np.mean(np.sign(a - start[k]) != np.sign(b - start[k]))
            assert flips <= max(0.05, 4 / a.size), (k, flips)
    for mom in ("m", "v"):
        for net in ("G", "D"):
            keys = [k for k in got_m if k.startswith(f"{mom}.{net}.")
                    and not BN_FED_BIAS.match(k[2:])]
            a = np.concatenate([got_m[k].ravel() for k in keys])
            b = np.concatenate([want_m[k].ravel() for k in keys])
            assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b), \
                (mom, net)


@pytest.mark.parametrize("case", [
    # (d_moments = d_params, d_concat, legacy_detach, the port's g_fuse)
    ("f32", True, False, "train"),
    ("bf16", True, False, "eval"),
    ("f32", False, True, "eval"),
], ids=["f32-concat-gfuse_train", "bf16-concat", "f32-sequential-legacy"])
def test_train_step_matches_tpusr(case):
    dtype, d_concat, legacy_detach, g_fuse = case
    kw = dict(SHAPE, d_moments=dtype, d_params=dtype, d_concat=d_concat,
              legacy_detach=legacy_detach)
    jc = jg.GANTrainConfig(**kw)
    pc = pg.GANTrainConfig(**kw, g_fuse=g_fuse)
    js = _strong(jax.jit(lambda k: jg.create_gan_state(k, jc, LR))(
        jax.random.key(0)))
    step = jax.jit(lambda s, lo, hi: jg._train_step_core(s, lo, hi, jc, LR,
                                                         JL.mse))
    ps = pg.create_gan_state(pc, LR, device="cpu")
    load_flax_gan_state(ps, jax.tree.map(np.asarray, js))
    start = _port_flat(ps)[0]
    for i, (lo, hi) in enumerate(_batches(), 1):
        js, jlog = step(js, jnp.asarray(lo), jnp.asarray(hi))
        js = _strong(js)
        ps, plog = pg.gan_train_step(ps, torch.from_numpy(lo),
                                     torch.from_numpy(hi), pc)
        for k in ("loss_D", "loss_G"):
            np.testing.assert_allclose(float(plog[k]), float(jlog[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
        if i in (1, 3):
            _compare(ps, js, start, i)
    assert ps.step == int(js.step) == 3


def _port_state(**kw):
    cfg = pg.GANTrainConfig(**SHAPE, **kw)
    ps = pg.create_gan_state(cfg, 1e-4, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    return cfg, ps


def _step_once(cfg, ps):
    lo, hi = _batches(1)[0]
    return pg.gan_train_step(ps, torch.from_numpy(lo), torch.from_numpy(hi),
                             cfg)


def test_g_fuse_train_matches_eval_on_the_cpu():
    """The fused route (kernels A and B's plain versions here) computes the
    step's function: losses, G's parameters and statistics as the cuDNN
    route's."""
    out = {}
    for g_fuse in ("train", "eval"):
        cfg, ps = _port_state(g_fuse=g_fuse, d_moments="f32", d_params="f32")
        ps, logs = _step_once(cfg, ps)
        out[g_fuse] = ({k: float(v) for k, v in logs.items()},
                       {k: v.detach().clone() for k, v in
                        ps.G.state_dict().items()})
    for k in ("loss_D", "loss_G"):
        assert out["train"][0][k] == pytest.approx(out["eval"][0][k],
                                                   rel=1e-5)
    for k, v in out["train"][1].items():
        lim = 2e-4 if BN_FED_BIAS.match(f"G.{k}") else 1e-5
        torch.testing.assert_close(v, out["eval"][1][k], rtol=1e-5,
                                   atol=lim, msg=k)


def test_d_concat_matches_sequential_calls():
    """One concat(real, fake) application with stat_groups=2 gives the two
    sequential calls' logits and running statistics."""
    _, ps = _port_state()
    D = ps.D
    gen = torch.Generator().manual_seed(1)
    real = torch.randn(4, 3, 32, 32, generator=gen) * 0.5
    fake = torch.randn(4, 3, 32, 32, generator=gen) * 0.5
    before = {k: v.clone() for k, v in D.state_dict().items()}
    with torch.no_grad():
        seq = torch.cat([D(real, True), D(fake, True)])
        seq_stats = {k: v.clone() for k, v in D.state_dict().items()}
        D.load_state_dict(before)
        cat = D(torch.cat([real, fake]), True, 2)
    torch.testing.assert_close(cat, seq, rtol=1e-5, atol=1e-6)
    for k, v in D.state_dict().items():
        torch.testing.assert_close(v, seq_stats[k], rtol=1e-5, atol=1e-7,
                                   msg=k)


def test_grouped_batch_norm_refuses_the_fused_hooks():
    from tpusr_torch.models.layers import BatchNorm

    bn = BatchNorm(4)
    with pytest.raises(ValueError, match="stat_groups"):
        bn(torch.zeros(2, 4, 3, 3), stat_groups=2, return_affine=True)


def test_legacy_detach_keeps_the_loss_and_changes_g():
    """legacy_detach: the same loss values, but no adversarial gradient on
    G, so G's update differs."""
    res = {}
    for legacy in (False, True):
        cfg, ps = _port_state(legacy_detach=legacy)
        ps, logs = _step_once(cfg, ps)
        res[legacy] = (float(logs["loss_G"]),
                       ps.G.conv1.weight.detach().clone())
    assert res[True][0] == pytest.approx(res[False][0], rel=1e-6)
    assert not torch.equal(res[True][1], res[False][1])


def test_bf16_state_storage():
    """d_params='bf16': D's leaves of at least 2^20 elements in bf16, the
    rest and all of G in f32; bf16 moments; d_params='bf16' needs
    d_moments='bf16'."""
    cfg, ps = _port_state(d_moments="bf16", d_params="bf16")
    big = {k for k, p in ps.D.named_parameters() if p.numel() >= 1 << 20}
    assert big == {"dense1.weight", "block5_conv.weight",
                   "block6_conv.weight"}
    for k, p in ps.D.named_parameters():
        assert p.dtype == (torch.bfloat16 if k in big else torch.float32)
    assert all(p.dtype == torch.float32 for p in ps.G.parameters())
    assert isinstance(ps.opt_D, pg.Bf16Adam)
    assert all(m.dtype == torch.bfloat16 for m in ps.opt_D.m + ps.opt_D.v)
    ps, logs = _step_once(cfg, ps)
    assert ps.D.dense1.weight.dtype == torch.bfloat16
    assert np.isfinite(float(logs["loss_D"]))
    with pytest.raises(ValueError, match="d_moments"):
        pg.create_gan_state(dataclasses.replace(cfg, d_moments="f32"), 1e-4,
                            device="cpu")


def test_adam_f32_matches_bf16_update_math():
    """torch.optim.Adam and bf16_adam_update compute the same f32 update;
    only the moments' storage rounds."""
    gen = torch.Generator().manual_seed(2)
    p32 = torch.nn.Parameter(torch.randn(64, generator=gen))
    p16 = torch.nn.Parameter(p32.detach().clone())
    a32, a16 = pg._adam([p32], 1e-2), pg._adam([p16], 1e-2, "bf16")
    for _ in range(5):
        g = torch.randn(64, generator=gen)
        p32.grad, p16.grad = g.clone(), g.clone()
        a32.step()
        a16.step()
    count, ms, _ = pg.adam_moments(a32)
    assert count == a16.count == 5
    # m rounds to bf16 (2^-8) at each of the 5 steps
    torch.testing.assert_close(a16.m[0].float(), ms[0], rtol=3e-2, atol=2e-3)
    torch.testing.assert_close(p16.detach(), p32.detach(), rtol=0, atol=2e-4)
