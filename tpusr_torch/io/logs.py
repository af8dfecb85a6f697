"""Run logging — text parity with utils/common.py:35-43 plus structured JSONL.

A copy of tpusr/io/logs.py, so the port's ``*_log.txt`` format is the same.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np


def save_log(out_dir: str, **kwargs) -> str:
    """Timestamped `key: value` text log (byte-format parity with the
    reference) plus a sibling .jsonl with JSON-serializable values."""
    os.makedirs(out_dir, exist_ok=True)
    stamp = datetime.now().strftime("%Y_%m_%d_%p%I_%M")
    # two logs within the same minute (e.g. both GAN phases on fast runs)
    # must not clobber each other — the reference overwrites here
    suffix = ""
    n = 1
    while os.path.exists(os.path.join(out_dir, f"{stamp}{suffix}_log.txt")):
        suffix = f"_{n}"
        n += 1
    stamp = f"{stamp}{suffix}"
    path = os.path.join(out_dir, f"{stamp}_log.txt")
    with open(path, "w") as f:
        for key, value in kwargs.items():
            f.write(f"{key}: {str(value)}\n")

    jpath = os.path.join(out_dir, f"{stamp}_log.jsonl")
    with open(jpath, "w") as f:
        for key, value in kwargs.items():
            if isinstance(value, np.ndarray):
                value = value.tolist()
            try:
                json.dumps(value)
            except TypeError:
                value = str(value)
            f.write(json.dumps({"key": key, "value": value}) + "\n")

    print(f"Log file saved to {path}")
    return path
