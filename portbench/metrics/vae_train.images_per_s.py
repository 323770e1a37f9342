"""Training images of the window's whole epochs over its host seconds
(the window of a ``--trace 1`` run runs untraced): the rate a user's
epochs run at, which the host's dispatch of each step paces."""


def read(trace, info):
    if info.get("stage") != "vae_train" or not info.get("images"):
        return None
    return info["images"] / info["window_s"]
