"""serve_frames_per_s: the valid encoder frames of every batch finished
inside the window, over the window's seconds."""


def read(run):
    if run.kind != "serve":
        return None
    return sum(u["valid_frames"] for u in run.done()) / run.window_s
