"""The model's operations for the images answered in the window (every conv
stage and the head, from the configuration's shapes) over the window's
seconds, as a share of the H100's f32 peak (the configuration computes in
f32 off the tensor cores), in %."""
from portbench.yardstick import HW, cnn_flops_per_image


def read(run):
    flops = run.counters["images"] * cnn_flops_per_image(run.cfg)
    return 100.0 * flops / (run.window_s * HW().f32_flops)
