"""Small sizes of each cell for the CPU tests: the same code paths, the
widths cut so that a test run holds them. The training cell runs in f32
here: with a batch of 2 at 32 x 32 patches, bf16's rounding moves the
small leaves' gradients by tenths, which says nothing of the port."""

SMALL = {
    "dip-x8-f32": {
        "config": {"num_scales": 3, "skip_n33d": 16, "skip_n33u": 16,
                   "input_depth": 8, "hr_size": [128, 128], "num_iter": 6,
                   "log_freq": 3},
        "cell": {"image_pool": 2, "min_calls": 2,
                 "trace": {"wait": 1, "active": 2, "tries": 2}}},
    "dip-x8-lanes4": {
        "config": {"num_scales": 3, "skip_n33d": 16, "skip_n33u": 16,
                   "input_depth": 8, "hr_size": [128, 128], "num_iter": 6,
                   "log_freq": 3},
        "cell": {"image_pool": 1, "min_calls": 2,
                 "trace": {"wait": 1, "active": 2, "tries": 2}}},
    "srgan-x8-eval-f32": {
        "config": {"residual_blocks_count": 2},
        "cell": {"lr_sizes": [[6, 10], [10, 6]], "image_pool": 4,
                 "trace": {"wait": 1, "active": 2, "tries": 2}}},
    "srgan-x8-train-bf16": {
        "config": {"residual_blocks_count": 1},
        "cell": {"train": {"dtype": "float32", "hr_patch": 32,
                           "batch_size": 2},
                 "images": 6, "hr_size": [64, 96],
                 "trace": {"wait": 1, "active": 2, "tries": 2}}},
}
