"""Host milliseconds a training step: the mean length of the program's
``vqvae.vae.train_step`` spans (the loop body of ``train_epoch``: the
batch's index slice, the step, the running sums) in the first traced
epoch, the one that traces the device's activity alone. The profiler
slows the host, so this reads above the untraced window's seconds a step
(PERF.md gives the factor). Nothing from a program without the spans."""
from portbench import spans


def read(trace, info):
    rows = spans.first_stretch("vqvae.vae.train_epoch")
    if info.get("stage") != "vae_train" or rows is None:
        return None
    steps = [r.end - r.start for r in rows
             if r.name == "vqvae.vae.train_step" and r.count is None]
    return 1e-6 * sum(steps) / len(steps) if steps else None
