"""pack_fill.serve: the valid frames of the traced window's batches over the
frames the model computed for them (packed rows times their capacity, or
batch rows times the padded length), in percent. A count: it repeats
exactly for the same batches. Moves ``serve_frames_per_s``."""


def read(run):
    units = run.done()
    if run.kind != "serve" or run.trace is None or not units:
        return None
    return 100.0 * (sum(u["valid_frames"] for u in units)
                    / sum(u["computed_frames"] for u in units))
