"""The operation and byte counters against hand counts."""

from srbench import yardstick as Y

DIP_SMALL = {"skip_n33d": 8, "skip_n33u": 8, "skip_n11": 2,
             "num_scales": 2, "input_depth": 4, "factor": 8}


def test_conv_flops_and_bound():
    assert Y.conv_flops(1, 2, 3, 4, 5, 3) == 2 * 2 * 3 * 4 * 5 * 9
    assert Y.bound_s(495e12, 0, "float32") == 1.0
    assert Y.bound_s(0, 3.35e12, "bfloat16") == 1.0
    assert Y.bound_s(989e12, 3.35e12 * 2, "bfloat16") == 2.0


def test_skip_net_convs_by_hand():
    convs = {c.name: c for c in Y.skip_net_convs(DIP_SMALL, 16, 16)}
    assert sorted(convs) == sorted(
        [f"{p}{i}_{s}" for i in (0, 1) for p, s in
         (("skip", "conv"), ("down", "conv1"), ("down", "conv2"),
          ("up", "conv"), ("up", "conv1x1"))] + ["head_conv"])
    # level 0: 16 x 16 input, 4 -> 2 skip, 4 -> 8 stride 2, 8 -> 8 at 8 x 8,
    # (2 + 8) -> 8 merge at 16 x 16, 8 -> 8 1x1; head 8 -> 3
    assert convs["skip0_conv"].fwd_flops() == 2 * 256 * 4 * 2
    assert convs["down0_conv1"].fwd_flops() == 2 * 64 * 4 * 8 * 9
    assert convs["down0_conv2"].fwd_flops() == 2 * 64 * 8 * 8 * 9
    assert convs["up0_conv"].fwd_flops() == 2 * 256 * 10 * 8 * 9
    assert convs["down1_conv2"].fwd_flops() == 2 * 16 * 8 * 8 * 9
    assert convs["head_conv"].fwd_flops() == 2 * 256 * 8 * 3
    # the convs that read z need no input gradient
    assert convs["skip0_conv"].train_flops() == 2 * convs[
        "skip0_conv"].fwd_flops()
    assert convs["up0_conv"].train_flops() == 3 * convs[
        "up0_conv"].fwd_flops()


def test_dip_flops_by_hand():
    train, fwd = Y.dip_flops(DIP_SMALL, 16, 16)
    convs = Y.skip_net_convs(DIP_SMALL, 16, 16)
    down = 2 * 3 * 2 * 2 * 32 * 32  # 2 x 2 LR outputs, 32 x 32 taps
    assert fwd == sum(c.fwd_flops() for c in convs)
    assert train == sum(c.train_flops() for c in convs) + 2 * down
    assert Y.dip_flops(DIP_SMALL, 16, 16, lanes=4) == (4 * train, 4 * fwd)


def test_dip_fused_launches_by_hand():
    launches = Y.dip_fused_launches(DIP_SMALL, 16, 16, "float32")
    assert [k for k, _, _ in launches] == ["A", "A", "B"] * 4
    # scale 0, the down conv: 8 x 8, 8 -> 8, prologue and stats
    _, fl, fwd = launches[0]
    assert fl == 2 * 64 * 8 * 8 * 9
    assert fwd == (64 * 8 + 64 * 8) * 4 + 9 * 64 * 4 + 2 * 8 * 4 * 2
    assert launches[1][2] == (64 * 8 + 64 * 8) * 4 + 9 * 64 * 4
    assert launches[2][2] == (64 * 8 * 2) * 4 + 2 * 8 * 4 + 9 * 64 * 4
    # scale 0, the merge conv's trunk: 16 x 16, 8 -> 8, with a base
    _, fl, fwd = launches[3]
    assert fl == 2 * 256 * 8 * 8 * 9
    assert fwd == (256 * 8 + 256 * 8 * 2) * 4 + 9 * 64 * 4 + 2 * 8 * 4 * 2


def test_srgan_counts_by_hand():
    cfg = {"n_features": 64, "residual_blocks_count": 2, "n_shuffles": 3}
    convs = Y.srgan_generator_convs(cfg, 3, 5)
    assert [c.name for c in convs] == [
        "conv1", "res0.conv1", "res0.conv2", "res1.conv1", "res1.conv2",
        "conv2", "ps0.conv1", "ps1.conv1", "ps2.conv1", "conv3"]
    assert convs[0].fwd_flops() == 2 * 15 * 3 * 64 * 81
    assert convs[-2].fwd_flops() == 2 * (12 * 20) * 64 * 256 * 9
    assert convs[-1].fwd_flops() == 2 * (24 * 40) * 64 * 3 * 81
    launches = Y.srgan_eval_launches(cfg, 3, 5, "float32")
    assert len(launches) == 8
    assert launches[0][2] == (15 * 64 * 2 + 9 * 64 * 64) * 4
    d, first = Y.srgan_discriminator_fwd(16)
    assert first == 2 * 256 * 3 * 64 * 9
    sides = [8, 8, 4, 4, 2, 2, 1]
    chans = [64, 64, 128, 128, 256, 256, 512, 512]
    assert d == first + sum(2 * s * s * ci * co * 9 for s, ci, co in
                            zip(sides, chans[:-1], chans[1:])) \
        + 2 * 512 * 1024 + 2 * 1024
    assert Y.vgg19_fwd(16) == (2 * 256 * 9 * (3 * 64 + 64 * 64)
                               + 2 * 64 * 9 * (64 * 128 + 128 * 128)
                               + 2 * 16 * 9 * (128 * 256 + 3 * 256 * 256)
                               + 2 * 4 * 9 * (256 * 512 + 3 * 512 * 512)
                               + 2 * 1 * 9 * 4 * 512 * 512)
