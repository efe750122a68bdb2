"""apply_idle_share.train: the share of the traced window in which the card
was idle while the port's trainer dispatched the optimizer's apply
(``sslc.train.apply``: the clip and Adam over every parameter), in
percent: a part of ``idle_share.train`` (``h100_bench/spans.py``). Moves
``train_frames_per_s``."""

from h100_bench import spans

SPANS = ("sslc.train.apply",)


def read(run):
    return spans.train_idle_share(run, SPANS)
