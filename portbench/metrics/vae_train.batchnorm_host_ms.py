"""Host milliseconds a training step inside BatchNorm: the summed length
of the program's ``vqvae.vae.batchnorm`` (every norm's training forward)
and ``vqvae.vae.batchnorm_backward`` (its backward, on autograd's thread)
spans in the first traced epoch, over its ``vqvae.vae.train_step`` spans.
The evaluation pass normalizes by the running statistics and opens
neither. Nothing from a program without the spans."""
from portbench import spans


def read(trace, info):
    rows = spans.first_stretch("vqvae.vae.train_epoch")
    if info.get("stage") != "vae_train" or rows is None:
        return None
    steps = sum(1 for r in rows if r.name == "vqvae.vae.train_step")
    if not steps:
        return None
    return 1e3 * spans.seconds(rows, "vqvae.vae.batchnorm",
                               "vqvae.vae.batchnorm_backward") / steps
