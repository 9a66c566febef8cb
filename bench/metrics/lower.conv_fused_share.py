"""The conv segments the lowering gave the fused conv kernel, over all its `tiled_conv` segments, in %: the
program's counters `lower.conv.fused` and `lower.route.tiled_conv` (`repro_torch.obs`) once the window has
closed.  A program without the first counter reads None."""


def read(run):
    from repro_torch import obs

    counters = obs.metrics_dict()["counters"]
    convs = counters.get("lower.route.tiled_conv", 0)
    if "lower.conv.fused" not in counters or convs <= 0:
        return None
    return 100.0 * counters["lower.conv.fused"] / convs
