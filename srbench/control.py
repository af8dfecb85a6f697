"""The control of a cell's comparison: the plain reference computed one
precision below the configuration's (bf16 for its f32, fp8 operands for
its bf16), put in the program's place, and the faults the cell can have.
Its readings are the upper ends the limits in the cell's file are set
below; the benchmark's own runs do not run it. A driver whose control
starts from the state its window trains from (``CONTROL_AFTER_WINDOW``)
runs its set-up and a window of one unit first, and the sound readings
of that run come out beside the control's.

    python3 -m srbench.control --workload NAME --seeds N [N ...] [--calls K]

prints one JSON line per seed with the readings of every number the cell
compares.
"""

from __future__ import annotations

import argparse
import json
import sys

from srbench.run import load_cell, make_driver


def control(cell: dict, config: dict, seed: int, calls: int,
            device) -> dict:
    driver = make_driver(cell, config, seed, device)
    if getattr(driver, "CONTROL_AFTER_WINDOW", False):
        driver.setup()
        driver.run_window(0.0)
        driver.release()
        return {"sound": driver.check(), **driver.control(calls)}
    driver.prepare_inputs()
    return driver.control(calls)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=1)
    args = p.parse_args(argv)
    _, _, cell, config = load_cell(args.workload)
    for seed in args.seeds:
        got = control(cell, config, seed, args.calls,
                      torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "control": got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
