"""Share of the window in which no operation ran on the device: the
device-busy seconds a build (the union of kernel, copy and set intervals
of the build traced after the window) times the window's builds, against
the window's seconds."""


def read(trace, info):
    if info.get("stage") != "codebook" or trace is None \
            or not (info.get("traced") or {}).get("builds"):
        return None
    busy = trace.busy_s
    if busy <= 0:
        return None
    per_build = busy / info["traced"]["builds"]
    return 100.0 * (1.0 - per_build * info["builds"] / info["window_s"])
