"""train_frames_per_s: the valid frames of every whole optimizer update
finished inside the window, over the window's seconds."""


def read(run):
    if run.kind != "train":
        return None
    return sum(u["valid_frames"] for u in run.done()) / run.window_s
