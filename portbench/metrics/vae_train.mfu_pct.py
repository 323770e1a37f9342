"""Model FLOPs of the window (the benchmark's count from the
configuration's shapes: each training step's forward and twice it for the
backward, and each evaluation pass's forward) over the window's host
seconds (the window runs untraced), as a share of the H100's float32 peak
(TF32 is off in the port, so the CUDA cores' 67 TFLOP/s are the peak its
arithmetic can use)."""
from portbench import yardstick


def read(trace, info):
    if info.get("stage") != "vae_train" or not info.get("flops"):
        return None
    return 100.0 * info["flops"] / info["window_s"] / yardstick.F32_FLOPS
