"""Model FLOPs of the epoch traced after the window (the benchmark's
count, as ``vae_train.mfu_pct``'s) over that epoch's device-busy seconds
(the union of kernel, copy and set intervals), as a share of the H100's
float32 peak: the whole step's share on the card, which bounds
``vae_train_epoch_device_s`` as ``vae_train.mfu_pct`` bounds the rate."""
from portbench import yardstick


def read(trace, info):
    flops = (info.get("traced") or {}).get("flops")
    if info.get("stage") != "vae_train" or trace is None or not flops:
        return None
    busy = trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * flops / busy / yardstick.F32_FLOPS
