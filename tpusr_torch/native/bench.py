"""Time the native loader against the PIL path on DIV2K-sized PNGs.

    python -m tpusr_torch.native.bench [--pairs 4] [--repeats 5] [--seed 0]

Writes ``--pairs`` synthetic pairs at DIV2K's sizes (a 2040 x 1356 HR
PNG and its 255 x 170 x8 LR, smooth content plus noise, so the PNGs
compress about as photographs do) to a temporary directory, then loads
each pair through ``native.load_pair`` and through ``data.div2k``'s PIL
chain, with ``downsample`` off and on, and prints one JSON object: the
median over ``--repeats`` of the seconds per pair for each path, their
ratio, and whether the bytes agreed. Host only; one thread per call, as
``get_image_pair`` runs.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import tempfile
import time

import numpy as np
from PIL import Image

HR_SIZE = (2040, 1356)  # (w, h) of most DIV2K HR images
FACTOR = 8


def write_pairs(root: str, pairs: int, seed: int):
    """``pairs`` DIV2K-named HR/LR x8 PNG pairs under root; their paths."""
    rng = np.random.default_rng(seed)
    w, h = HR_SIZE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(pairs):
        img = np.stack([np.sin(xx / (37.0 + 3 * i)) * np.cos(yy / 53.0),
                        np.sin((xx + yy) / (71.0 + i)),
                        np.cos(xx / 29.0 - yy / 41.0)], -1) * 90 + 128
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
        hr = Image.fromarray(img.astype(np.uint8))
        lr = hr.resize((w // FACTOR, h // FACTOR), Image.BICUBIC)
        hr_p = os.path.join(root, f"{i + 1:04d}.png")
        lr_p = os.path.join(root, f"{i + 1:04d}x8.png")
        hr.save(hr_p)
        lr.save(lr_p)
        out.append((hr_p, lr_p))
    return out


def _median_seconds(fn, paths, repeats: int) -> float:
    per = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for hr_p, lr_p in paths:
            fn(hr_p, lr_p)
        per.append((time.perf_counter() - t0) / len(paths))
    return float(np.median(per))


def main(argv=None) -> int:
    from tpusr_torch import native
    from tpusr_torch.data import div2k

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not native.available():
        print(json.dumps({"native": native.status()}))
        return 1
    rows = {}
    with tempfile.TemporaryDirectory() as root:
        paths = write_pairs(root, args.pairs, args.seed)
        for down in (False, True):
            cfg = div2k.DatasetConfig(LR_dir=root, HR_dir=root,
                                      scale_factor=FACTOR, downsample=down)

            def nat(hr_p, lr_p, down=down):
                return native.load_pair(hr_p, lr_p, FACTOR, down)

            def pil(hr_p, lr_p, cfg=cfg):
                return div2k._pil_pair(cfg, hr_p, lr_p)

            same = all(np.array_equal(a, b) for hr_p, lr_p in paths
                       for a, b in zip(nat(hr_p, lr_p), pil(hr_p, lr_p)))
            t_nat = _median_seconds(nat, paths, args.repeats)
            t_pil = _median_seconds(pil, paths, args.repeats)
            rows[f"downsample={down}"] = dict(
                native_s=t_nat, pil_s=t_pil, pil_over_native=t_pil / t_nat,
                bytes_equal=same)
    print(json.dumps({"host": platform.processor() or platform.machine(),
                      "cpus": os.cpu_count(), "pairs": args.pairs,
                      "repeats": args.repeats, "hr_size": HR_SIZE,
                      "seconds_per_pair": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
