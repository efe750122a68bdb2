"""dispatch_idle_share.train: the share of the traced window in which the
card was idle while the port's grad step dispatched its forward and loss
(``sslc.train.forward``) or its backward (``sslc.train.backward``), in
percent: a part of ``idle_share.train`` (``h100_bench/spans.py``). Moves
``train_frames_per_s``."""

from h100_bench import spans

SPANS = ("sslc.train.forward", "sslc.train.backward")


def read(run):
    return spans.train_idle_share(run, SPANS)
