"""Tokens the mid-block attention attends over a training step: the
program's counter ``vqvae.kl.attention_tokens`` (batch x grid height x
width, per attention call) summed inside the ``vqvae.vae.train_step``
spans of the first traced epoch, over those steps. Both mid blocks at the
latent grid read 2 x batch x grid^2. Nothing from a program without the
counter."""
from portbench import spans


def read(trace, info):
    rows = spans.first_stretch("vqvae.vae.train_epoch")
    if info.get("stage") != "vae_train" or rows is None:
        return None
    steps = [r for r in rows
             if r.name == "vqvae.vae.train_step" and r.count is None]
    counts = [r for r in rows
              if r.name == "vqvae.kl.attention_tokens" and r.count is not None]
    if not steps or not counts:
        return None
    inside = sum(c.count for c in counts
                 if any(s.start <= c.start <= s.end for s in steps))
    return inside / len(steps)
