"""BatchNorm calls that ran the hand-written kernels in a training step:
the program's counter ``vqvae.vae.batchnorm_kernel`` (one for each
training forward and one for each backward of a norm on the card) summed
inside the ``vqvae.vae.train_step`` spans of the first traced epoch, over
those steps. A VAE of five norms reads 10. Nothing from a program without
the counter, or whose norms did not run the kernels."""
from portbench import spans


def read(trace, info):
    rows = spans.first_stretch("vqvae.vae.train_epoch")
    if info.get("stage") != "vae_train" or rows is None:
        return None
    steps = [r for r in rows
             if r.name == "vqvae.vae.train_step" and r.count is None]
    counts = [r for r in rows if r.name == "vqvae.vae.batchnorm_kernel"
              and r.count is not None]
    if not steps or not counts:
        return None
    inside = sum(c.count for c in counts
                 if any(s.start <= c.start <= s.end for s in steps))
    return inside / len(steps)
