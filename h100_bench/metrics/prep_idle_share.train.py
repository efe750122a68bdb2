"""prep_idle_share.train: the share of the traced window in which the card
was idle while the port's trainer uploaded a micro-batch
(``sslc.train.upload``) or drew its span mask on the host
(``sslc.train.span_mask``), in percent: a part of ``idle_share.train``
(``h100_bench/spans.py``). Moves ``train_frames_per_s``."""

from h100_bench import spans

SPANS = ("sslc.train.upload", "sslc.train.span_mask")


def read(run):
    return spans.train_idle_share(run, SPANS)
