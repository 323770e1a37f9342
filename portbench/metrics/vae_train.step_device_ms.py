"""Device-busy milliseconds (the union of kernel, copy and set intervals)
per training step of the epoch traced after the window; its evaluation
pass's device time is in it."""


def read(trace, info):
    steps = (info.get("traced") or {}).get("train_steps")
    if info.get("stage") != "vae_train" or trace is None or not steps:
        return None
    busy = trace.busy_s
    return 1e3 * busy / steps if busy > 0 else None
