"""SRGAN training CLI on the card — the port of ``tpusr/cli/train_gan.py``.

Usage (flags and defaults are tpusr's, itself train_GAN.py:211-224, plus
--device):
    python -m tpusr_torch.cli.train_gan --data_dir D --out_dir O \
        [--pre_train_epochs 8000] [--fine_tune_epochs 4000] \
        [--train_log_freq 100] [--hr_patch_size 192] [--batch_size 8] \
        [--residual_blocks 16] [--dtype float32|bfloat16] [--device cuda]

Two phases (train_GAN.py:180-205), pre-train then fine-tune, each with
fresh Adam; after each, the generator and discriminator as reference-named
.pth files, the whole training state (``{prefix}_state``, an orbax
checkpoint directory in tpusr's tree) and a metrics log, under
``<out>/trained/GANx{f}/<timestamp>/``. The default trainer keeps the
uint8 images on the card and crops there (``engine/gan_epochs.py``), one
chunk per log cadence; ``--host_loop True`` runs the reference-style
per-step loop. --checkpoint_every writes ``ckpt_epoch{n}`` directories.
--resume takes such a state directory (or a ``{prefix}_state``), written
by tpusr or by the port (or a state file of the port's earlier torch.save
format); --pre_trained_models_path a run directory holding
``pre_trained_state`` (tpusr's or the port's) or the
``pre_trained_srgan_G.pth`` / ``_D.pth`` pair (both packages write the
pair). tpusr's train CLI resumes the port's directories the same way.
--profile_dir is accepted and unused, as in tpusr.

--data_parallel True trains data-parallel over W ranks, one per card
(``parallel/gan_dp.py``): each step's global batch of --batch_size (which
W must divide) is split over the ranks, BatchNorm statistics and
gradients are the global batch's, and rank 0 alone prints, logs and
writes the files (the same set and names). Under torchrun the CLI joins
the launched group; launched plainly it spawns one rank per visible card
(on the CPU, one rank).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpusr_torch.cli.common import (check_num_images, join_ranks,
                                    planned_ranks, quiet_unless_rank0,
                                    require_dir, str2bool, timestamp)
from tpusr_torch.data.div2k import GANDIV2KDataset, batch_iterator
from tpusr_torch.device import resolve_device
from tpusr_torch.engine.gan import (GANTrainConfig, create_gan_state,
                                    gan_train_step, generator_forward)
from tpusr_torch.engine.gan_epochs import (gan_train_epochs,
                                           stack_dataset_for_device)
from tpusr_torch.engine.losses import make_content_loss
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.io.checkpoint import (export_torch_discriminator,
                                       export_torch_generator,
                                       import_torch_discriminator,
                                       import_torch_generator,
                                       load_torch_state_dict,
                                       load_train_state, save_torch_pth,
                                       save_train_state)
from tpusr_torch.io.logs import save_log
from tpusr_torch.models.lpips import make_lpips
from tpusr_torch.models.srgan import N_SHUFFLES
from tpusr_torch.models.vgg19 import try_load_vgg19
from tpusr_torch.parallel.gan_dp import make_dp_forward, make_dp_train_step
from tpusr_torch.parallel.mesh import make_mesh


def train_phase(state, dataset, config: GANTrainConfig, num_epoch,
                train_log_freq, content_loss, lpips_fn, ckpt_dir=None,
                ckpt_every=0, device="cuda", step_fn=None, forward_fn=None):
    """GAN_ISR_train parity (train_GAN.py:22-136), one host step at a
    time; ``step_fn`` and ``forward_fn`` as ``gan_train_epochs`` takes
    them (the data-parallel step and metrics forward)."""
    print("Starting GAN training..")
    dev = resolve_device(device)
    avg_psnrs, avg_ssims, avg_lpipss = [], [], []
    losses_D, losses_G = [], []
    for epoch in range(num_epoch):
        start_time = time.time()
        dataset.set_epoch(epoch)
        epoch_psnrs, epoch_ssims, epoch_lpipss = [], [], []
        batches = 0
        for lr_b, hr_b, _ in batch_iterator(dataset, config.batch_size,
                                            pad_to_full=True):
            lr_b = torch.from_numpy(lr_b).to(dev)
            hr_b = torch.from_numpy(hr_b).to(dev)
            if step_fn is None:
                state, logs = gan_train_step(state, lr_b, hr_b, config,
                                             content_loss)
            else:
                state, logs = step_fn(state, lr_b, hr_b)
            losses_D.append(float(logs["loss_D"]))
            losses_G.append(float(logs["loss_G"]))
            batches += 1
            if epoch % train_log_freq == 0:
                with torch.no_grad():
                    out = (generator_forward(state.G, lr_b, config,
                                             train=True)
                           if forward_fn is None else forward_fn(state, lr_b))
                    epoch_psnrs.append(float(psnr_fn(out, hr_b)))
                    epoch_ssims.append(float(ssim_fn(out, hr_b,
                                                     data_range=1.0)))
                    epoch_lpipss.append(float(lpips_fn(out, hr_b))
                                        if lpips_fn else float("nan"))
        if epoch % train_log_freq == 0:
            avg_psnrs.append(sum(epoch_psnrs) / batches)
            avg_ssims.append(sum(epoch_ssims) / batches)
            avg_lpipss.append(sum(epoch_lpipss) / batches)
            print(f"Epoch {epoch + 1}/{num_epoch}:")
            print(f"Discriminator loss: {losses_D[-1]:.4f}")
            print(f"Generator loss: {losses_G[-1]:.4f}")
            print(f"Epoch run time: {time.time() - start_time:.2f}s")
        if ckpt_dir and ckpt_every and (epoch + 1) % ckpt_every == 0:
            save_train_state(os.path.join(ckpt_dir, f"ckpt_epoch{epoch + 1}"),
                             state)
    return state, {
        "Average PSNR during training": avg_psnrs,
        "Average SSIM during training": avg_ssims,
        "Average LPIPS during training": avg_lpipss,
        # the reference swaps these two log keys (train_GAN.py:132-133)
        "Final Generator loss": losses_G[-1] if losses_G else float("nan"),
        "Final Discriminator loss": losses_D[-1] if losses_D else float("nan"),
    }


def train_phase_ondevice(state, stacks, config: GANTrainConfig, num_epoch,
                         train_log_freq, content_loss, lpips_fn,
                         ckpt_dir=None, ckpt_every=0, generator=None,
                         device="cuda", step_fn=None, forward_fn=None):
    """GAN_ISR_train parity as on-device epoch chunks, one per log cadence
    (metrics from the chunk's first epoch, the reference's epoch %
    log_freq == 0). The uint8 stacks are uploaded once; ``generator`` (on
    the device) draws the crops."""
    print("Starting GAN training..")
    dev = resolve_device(device)
    lr_u8, hr_u8, valid = (torch.from_numpy(a).to(dev) for a in stacks)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    avg_psnrs, avg_ssims, avg_lpipss = [], [], []
    last_d = last_g = float("nan")
    done = 0
    while done < num_epoch:
        chunk = min(train_log_freq, num_epoch - done)
        start_time = time.time()
        state, logs = gan_train_epochs(
            state, lr_u8, hr_u8, valid, generator, config,
            content_loss=content_loss, n_epochs=chunk, lpips_fn=lpips_fn,
            step_fn=step_fn, forward_fn=forward_fn)
        losses_D = logs["losses_D"].cpu().numpy()
        losses_G = logs["losses_G"].cpu().numpy()
        last_d, last_g = float(losses_D[-1, -1]), float(losses_G[-1, -1])
        avg_psnrs.append(float(logs["psnr"]))
        avg_ssims.append(float(logs["ssim"]))
        avg_lpipss.append(float(logs["lpips"]))
        print(f"Epoch {done + 1}/{num_epoch}:")
        print(f"Discriminator loss: {losses_D[0, -1]:.4f}")
        print(f"Generator loss: {losses_G[0, -1]:.4f}")
        print(f"Chunk of {chunk} epochs run time: "
              f"{time.time() - start_time:.2f}s")
        done += chunk
        if ckpt_dir and ckpt_every and done % max(ckpt_every, 1) < chunk:
            save_train_state(os.path.join(ckpt_dir, f"ckpt_epoch{done}"),
                             state)
    return state, {
        "Average PSNR during training": avg_psnrs,
        "Average SSIM during training": avg_ssims,
        "Average LPIPS during training": avg_lpipss,
        "Final Generator loss": last_g,
        "Final Discriminator loss": last_d,
    }


def save_phase_models(state, prefix, out_dir, config: GANTrainConfig):
    """``{prefix}_state`` and the reference-named ``{prefix}_srgan_G.pth``
    / ``_D.pth`` (the reference persists both nets, train_GAN.py:188)."""
    save_train_state(os.path.join(out_dir, f"{prefix}_state"), state)
    save_torch_pth(export_torch_generator(
        state.G.state_dict(), config.residual_blocks_count,
        N_SHUFFLES[config.factor]),
        os.path.join(out_dir, f"{prefix}_srgan_G.pth"))
    save_torch_pth(export_torch_discriminator(state.D.state_dict(),
                                              config.hr_patch),
                   os.path.join(out_dir, f"{prefix}_srgan_D.pth"))


def load_pretrained(path: str, state, config: GANTrainConfig):
    """The pre-trained nets in ``path`` into ``state`` in place: its
    ``pre_trained_state`` (an orbax directory of tpusr or the port, or the
    port's earlier state file), else the ``pre_trained_srgan_G.pth`` /
    ``_D.pth`` pair (weights and running statistics: what the fine-tune
    phase keeps, with fresh Adam)."""
    st = os.path.join(path, "pre_trained_state")
    if os.path.exists(st):
        return load_train_state(st, state)
    g_pth = os.path.join(path, "pre_trained_srgan_G.pth")
    d_pth = os.path.join(path, "pre_trained_srgan_D.pth")
    if not (os.path.isfile(g_pth) and os.path.isfile(d_pth)):
        raise FileNotFoundError(
            f"{path} holds neither a pre_trained_state checkpoint nor the "
            f"pre_trained_srgan_G.pth / _D.pth pair")
    with torch.no_grad():
        for net, sd in (
                (state.G, import_torch_generator(
                    load_torch_state_dict(g_pth),
                    config.residual_blocks_count, N_SHUFFLES[config.factor])),
                (state.D, import_torch_discriminator(
                    load_torch_state_dict(d_pth), config.hr_patch))):
            own = net.state_dict()
            if set(own) != set(sd):
                raise KeyError(f"{path}: a .pth does not fit this model")
            for k, v in sd.items():
                own[k].copy_(v)
    return state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SRGAN training in PyTorch on an NVIDIA GPU")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--pre_train_epochs", type=int, default=8000)
    parser.add_argument("--fine_tune_epochs", type=int, default=4000)
    parser.add_argument("--pre_train_learning_rate", type=float, default=1e-4)
    parser.add_argument("--fine_tune_learning_rate", type=float, default=1e-5)
    parser.add_argument("--pre_trained_models_path", type=str)
    parser.add_argument("--train_log_freq", type=int, default=100)
    parser.add_argument("--num_images", type=int, default=-1)
    parser.add_argument("--downsample", type=str2bool, default=False)
    parser.add_argument("--legacy_detach", type=str2bool, default=False)
    parser.add_argument("--adv_weight", type=float, default=1.0,
                        help="G-loss adversarial coefficient; 1.0 = the "
                             "reference's unweighted sum, 1e-3 = the SRGAN "
                             "paper's value")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="epochs between crash-resume state files "
                             "(0 = off)")
    parser.add_argument("--resume", type=str,
                        help="orbax state checkpoint to resume from "
                             "(tpusr's or the port's)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hr_patch_size", type=int, default=192)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--residual_blocks", type=int, default=16)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--d_moments", type=str, default=None,
                        choices=["bf16", "f32"],
                        help="storage dtype of the discriminator's Adam "
                             "moments (default bf16; f32 is "
                             "torch.optim.Adam)")
    parser.add_argument("--d_params", type=str, default=None,
                        choices=["bf16", "f32"],
                        help="storage dtype of the discriminator's leaves "
                             "of at least 2^20 elements (default bf16; "
                             "the update's math stays f32)")
    parser.add_argument("--profile_dir", type=str)
    parser.add_argument("--data_parallel", type=str2bool, default=False,
                        help="split each batch over one rank per card "
                             "(global BatchNorm statistics and gradients; "
                             "joins a torchrun group)")
    parser.add_argument("--host_loop", type=str2bool, default=False,
                        help="use the per-step host loop (reference-style) "
                             "instead of the on-device epoch trainer")
    parser.add_argument("--legacy_scale", type=str2bool, default=False,
                        help="reproduce the reference's double-/255 image "
                             "scaling bug (dataset.py:151-157)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def run(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.data_parallel:
        cuda = torch.device(args.device).type == "cuda"
        n_dev = planned_ranks(torch.cuda.device_count()
                              if cuda and torch.cuda.is_available() else 1)
        if args.batch_size % n_dev != 0:
            print(f"--data_parallel requires batch_size ({args.batch_size}) "
                  f"divisible by device count ({n_dev})")
            sys.exit(1)
        if not join_ranks(run, argv, n_dev, args.device):
            return None  # the spawned ranks ran the training
    with quiet_unless_rank0():
        return _train(args)


def _train(args):
    require_dir(args.data_dir)
    require_dir(args.out_dir)
    check_num_images(args.num_images)
    dev = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        mesh = make_mesh(devices=dev.type)
        print(f"Data-parallel over {mesh.size()} devices")
    main = mesh is None or mesh.get_rank() == 0

    LR_dir = os.path.join(args.data_dir, "DIV2K_train_LR_x8/")
    HR_dir = os.path.join(args.data_dir, "DIV2K_train_HR/")
    factor = 8  # train_GAN.py:242
    if args.downsample:
        factor *= 2
    out_dir = os.path.join(args.out_dir, f"trained/GANx{factor}/{timestamp()}")
    if main:
        os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = out_dir if main else None
    hr_patch = args.hr_patch_size  # default 192, train_GAN.py:270
    lr_patch = hr_patch // factor

    config = GANTrainConfig(
        factor=factor, batch_size=args.batch_size, hr_patch=hr_patch,
        residual_blocks_count=args.residual_blocks,
        pre_train_epochs=args.pre_train_epochs,
        fine_tune_epochs=args.fine_tune_epochs,
        pre_train_lr=args.pre_train_learning_rate,
        fine_tune_lr=args.fine_tune_learning_rate,
        legacy_detach=args.legacy_detach, legacy_scale=args.legacy_scale,
        adv_weight=args.adv_weight,
        dtype=None if args.dtype == "float32" else args.dtype,
        **({"d_moments": args.d_moments} if args.d_moments else {}),
        # an explicit --d_moments f32 without --d_params drops the weight
        # storage to f32 too, as tpusr does (bf16 weights need f32 math)
        **({"d_params": args.d_params} if args.d_params
           else {"d_params": "f32"} if args.d_moments == "f32" else {}))

    vgg = try_load_vgg19(dev)
    content_loss = make_content_loss(vgg)
    print(f"Content loss: "
          f"{'VGG19 phi_5,4' if vgg else 'pixel MSE (no VGG weights)'}")
    lpips_fn = make_lpips()

    dataset = GANDIV2KDataset(
        LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=factor,
        num_images=args.num_images, LR_patch_size=(lr_patch, lr_patch),
        downsample=args.downsample, train=True, seed=args.seed,
        legacy_scale=args.legacy_scale)

    start_time = time.time()
    init = torch.Generator().manual_seed(args.seed)
    state = create_gan_state(config, config.pre_train_lr, generator=init,
                             device=dev)
    if args.resume:
        state = load_train_state(args.resume, state)
        print(f"Resumed from {args.resume} at step {state.step}")

    skip_pretrain = args.pre_trained_models_path is not None
    if skip_pretrain:
        state = load_pretrained(args.pre_trained_models_path, state, config)
        # fresh Adam for fine-tune (train_GAN.py:35-36 fresh per phase)
        state = create_gan_state(config, config.fine_tune_lr, G=state.G,
                                 D=state.D, device=dev)
    on_device = not args.host_loop
    stacks = None
    if on_device:
        stacks = stack_dataset_for_device(dataset, config.batch_size)
        # the reference raises on images smaller than the patch
        # (np.random.randint low >= high, dataset.py:128)
        too_small = (stacks[2] < lr_patch).any(axis=1)
        if too_small.any():
            print(f"{int(too_small.sum())} image(s) smaller than the "
                  f"{lr_patch}x{lr_patch} LR patch; reduce --hr_patch_size")
            sys.exit(1)

    phase_counter = [0]

    def run_phase(state, epochs, lr):
        phase_counter[0] += 1
        hooks = {}
        if mesh is not None:  # every rank starts the phase from rank 0's
            place, step_fn = make_dp_train_step(mesh, config, lr,
                                                content_loss)
            state = place(state)
            hooks = dict(step_fn=step_fn,
                         forward_fn=make_dp_forward(mesh, config))
        if on_device:
            # distinct crop streams per (seed, phase)
            seed = int(np.random.SeedSequence(
                [args.seed, phase_counter[0]]).generate_state(1)[0])
            return train_phase_ondevice(
                state, stacks, config, epochs, args.train_log_freq,
                content_loss, lpips_fn, ckpt_dir, args.checkpoint_every,
                generator=torch.Generator(device=dev).manual_seed(seed),
                device=dev, **hooks)
        return train_phase(state, dataset, config, epochs,
                           args.train_log_freq, content_loss, lpips_fn,
                           ckpt_dir, args.checkpoint_every, device=dev,
                           **hooks)

    if not skip_pretrain:
        print("Beginnning pre-training stage..")
        state, train_metrics = run_phase(state, config.pre_train_epochs,
                                         config.pre_train_lr)
        print("Done pre-training.")
        if main:
            save_log(out_dir, **train_metrics)
            save_phase_models(state, "pre_trained", out_dir, config)
        state = create_gan_state(config, config.fine_tune_lr, G=state.G,
                                 D=state.D, device=dev)

    print("Beginning fine-tuning stage")
    state, train_metrics = run_phase(state, config.fine_tune_epochs,
                                     config.fine_tune_lr)
    print("Done fine-tuning stage.")

    runtime = time.time() - start_time
    train_metrics["Number of images used for training"] = args.num_images
    train_metrics["Train runtime"] = time.strftime("%H:%M:%S",
                                                   time.gmtime(runtime))
    if main:
        save_log(out_dir, **train_metrics)
        save_phase_models(state, "fine_tuned", out_dir, config)
    return out_dir


if __name__ == "__main__":
    run()
