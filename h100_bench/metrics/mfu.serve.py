"""mfu.serve: the FLOPs the traced window's valid inputs need
(``h100_bench/flops.py``, padding not counted) over the window's seconds,
as a share of the card's peak in the cell's dtype, in percent. Moves
``serve_frames_per_s``."""

from h100_bench import flops


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    work = sum(u["flops"] for u in run.done())
    return 100.0 * work / run.window_s / flops.peak_flops(run.card,
                                                          run.dtype)
