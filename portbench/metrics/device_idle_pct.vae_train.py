"""Share of the window in which no operation ran on the device: the
device-busy seconds an epoch (the union of kernel, copy and set intervals
of the epoch traced after the window) times the window's epochs, against
the window's seconds. The traced epoch itself runs slower (the profiler
costs the host that launches it), so its own idle share would measure
the profiler."""


def read(trace, info):
    if info.get("stage") != "vae_train" or trace is None \
            or not (info.get("traced") or {}).get("epochs"):
        return None
    busy = trace.busy_s
    if busy <= 0:
        return None
    per_epoch = busy / info["traced"]["epochs"]
    return 100.0 * (1.0 - per_epoch * info["epochs"] / info["window_s"])
