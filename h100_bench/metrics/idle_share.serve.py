"""idle_share.serve: the share of the traced window in which no operation ran
on the card (one minus the union of the device's operation intervals over
the window), in percent. Moves ``serve_frames_per_s``."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
