"""The frozen yardsticks: stage-pass bounds against PERF.md's table of
kernels, UNet FLOPs against a count by hand, the stage-kernel metric's
bound sum, and the trace reduction on a hand-made trace."""
import pytest

from portbench import trace
from portbench.counts import stage_bounds, unet
from portbench.peaks import H100

S1 = (60, 224, 224, 1, 16)    # PERF.md: S1 = 60 x 224 x 224 x C16
S2 = (60, 112, 112, 16, 32)   # S2 = 60 x 112 x 112, C16 -> 32


@pytest.mark.parametrize("shape,de,name,ms", [
    (S1, True, "bnpool", 0.129), (S2, True, "bnpool", 0.065),
    (S1, True, "dz1", 0.187), (S2, True, "dz1", 0.093),
    (S1, True, "poolsums", 0.129), (S1, False, "poolsums", 0.072),
    (S1, False, "dz1", 0.129), (S2, True, "poolsums", 0.065),
])
def test_byte_bounds_match_the_kernel_table(shape, de, name, ms):
    """The pool passes are bound by their bytes; PERF.md's table gives them
    to three digits."""
    assert stage_bounds.stage_bounds(*shape, de=de)[name] * 1e3 == pytest.approx(ms, abs=6e-4)


@pytest.mark.parametrize("b", [60, 5000])
def test_convolution_passes_take_the_tf32_peak(b):
    """max(bytes at 3.35 TB/s, operations at 495 TFLOP/s): at the stage
    shapes the bytes bound even a convolution pass."""
    _, h, w, ci, c = S2
    px = b * h * w
    flops = 2.0 * 9 * c * c * px + 3.0 * px * c
    nbytes = px * 2 * c * 4 + 9 * c * c * 4
    assert stage_bounds.stage_bounds(b, h, w, ci, c)["bnconv"] == pytest.approx(
        max(flops / 495e12, nbytes / 3.35e12))


# a view at 224: (pixels, in, out) of each stage's two 3x3 convolutions
HAND = {"Conv1": (224 * 224, 1, 16), "Conv2": (112 * 112, 16, 32), "Conv3": (56 * 56, 32, 64),
        "Conv4": (28 * 28, 64, 128), "Conv5": (14 * 14, 128, 256)}


def test_encoder_flops_by_hand():
    layers = unet.conv_layers(256, 1, 4, 224, "Conv5")
    for stage, (px, ci, co) in HAND.items():
        got = unet.forward_flops([l for l in layers if l[0].startswith(stage + ".")])
        assert got == 2.0 * px * 9 * (ci * co + co * co)
    assert unet.forward_flops(layers) == pytest.approx(1.633e9, rel=1e-3)


def test_whole_unet_and_step_flops():
    layers = unet.conv_layers(256, 1, 4, 224)
    assert unet.forward_flops(layers) == pytest.approx(6.262e9, rel=1e-3)
    semi = {"driver": "semi"}
    program = {"Arch": {"max_channel": 256, "input_dim": 1, "num_classes": 4},
               "Data": {"crop": 224}, "LabeledLoader": {"batch_size": 32},
               "UnlabeledLoader": {"batch_size": 32}}
    f = unet.flops_per_step(semi, program)
    assert f == pytest.approx(96 * 3 * 6.262e9 + 32 * 6.262e9, rel=1e-3)
    pre = dict(program, ContrastiveLoaderParams={"scan_sample_num": 10, "partition_sample_num": 1},
               SPInfonceParams={"feature_names": "Conv5"})
    assert unet.flops_per_step({"driver": "pretrain"}, pre) == pytest.approx(294e9, rel=0.01)


def test_stage_bound_only_for_pallas_semi():
    program = {"Arch": {"max_channel": 256, "input_dim": 1, "num_classes": 4,
                        "small_c_layout": "pallas"}, "Data": {"crop": 224},
               "LabeledLoader": {"batch_size": 32}, "UnlabeledLoader": {"batch_size": 32}}
    s = unet.stage_bound_s_per_step({"driver": "semi"}, program)
    assert 0.5e-3 < s < 5e-3
    program["Arch"]["small_c_layout"] = "nhwc"
    assert unet.stage_bound_s_per_step({"driver": "semi"}, program) is None


def test_peaks_are_the_data_sheets():
    assert H100["tf32_flops"] == 495e12 and H100["hbm_bytes_per_s"] == 3.35e12


def test_trace_reduction_on_a_made_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.stretch", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.step", "ts": 0, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 60, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 90, "dur": 5},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "portbench.step", "ts": 0, "dur": 99}]
    r = trace.reduce(ev)
    assert r["launches"] == 2
    assert r["busy_us"] == 35 and r["span_us"] == 100
    assert r["device_ops"] == [("k1", 20e-6), ("k2", 20e-6), ("copy", 5e-6)]
    assert r["idle_gaps"][0] == ("portbench.stretch > aten::item", 50e-6)
