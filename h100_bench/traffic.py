"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

A mix fixes the work, and the seed only orders it and fills it in. The
utterance lengths are a grid of quantiles of the mix's length model,
dealt into a pool of batches by the mix's own ``deal_seed``, so every seed
runs the same batches (the same shapes, the same padding, the same
memory); the run's seed draws the order within each batch, the signal
itself and, where the mix's ``pass_order`` is "seeded", the order in
which each pass serves the pool.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import zlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    if mix.get("name") != name:
        raise ValueError(f"{path} names itself {mix.get('name')!r}")
    return mix


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of a run's ``seed`` (any
    integer: seeds may pass 32 bits)."""
    ss = np.random.SeedSequence([int(seed) % 2**63, zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def length_grid(model: dict, n: int) -> np.ndarray:
    """``n`` utterance lengths in seconds: the quantiles (i + 0.5) / n of
    the length model, clipped to its range. ``lognormal``: ``mean_s`` is
    the distribution's mean and ``sigma`` the spread of its logarithm."""
    if model["model"] != "lognormal":
        raise ValueError(f"unknown length model {model['model']!r}")
    sigma = float(model["sigma"])
    mu = math.log(float(model["mean_s"])) - sigma * sigma / 2.0
    normal = statistics.NormalDist(mu, sigma)
    secs = np.array([math.exp(normal.inv_cdf((i + 0.5) / n))
                     for i in range(n)])
    return np.clip(secs, float(model["min_s"]), float(model["max_s"]))


def pool(mix: dict) -> list:
    """The mix's pool: ``pool_batches`` lists of ``batch`` lengths in
    seconds, dealt from the length grid by ``deal_seed`` (the same for
    every run)."""
    model = mix["lengths"]
    b, n_batches = int(mix["batch"]), int(model["pool_batches"])
    secs = length_grid(model, b * n_batches)
    order = np.random.default_rng(int(model["deal_seed"])).permutation(
        len(secs))
    return [secs[order[i * b:(i + 1) * b]] for i in range(n_batches)]


class Schedule:
    """The order in which a run serves its pool, pass after pass: with
    ``pass_order`` "seeded" each pass is a permutation of the pool's
    batches drawn from the run's seed, with "fixed" it is the pool's own
    order (every seed then meets the same sequence of shapes); each
    batch's members come in an order drawn from the seed."""

    def __init__(self, n_batches: int, batch: int, seed: int,
                 pass_order: str = "seeded"):
        if pass_order not in ("seeded", "fixed"):
            raise ValueError(f"unknown pass_order {pass_order!r}")
        self.rng = np.random.default_rng(derive(seed, "order"))
        self.n_batches, self.batch = n_batches, batch
        self.seeded = pass_order == "seeded"
        self._pass: list = []

    def next(self) -> tuple:
        """(pool index, order of its members)."""
        if not self._pass:
            self._pass = (list(self.rng.permutation(self.n_batches))
                          if self.seeded else list(range(self.n_batches)))
        return int(self._pass.pop(0)), self.rng.permutation(self.batch)


def check_picks(lengths: list, batch: int, samples: int, seed: int):
    """The served utterances a check compares, drawn from the seed before
    the window: the pool's longest (its pool batch and member), taken at
    its first turn, and ``samples`` (window batch number, row) pairs among
    the first pass's batches."""
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng(derive(seed, "check"))
    n_batches = len(lengths) // batch
    picks = set()
    while len(picks) < samples:
        picks.add((int(rng.integers(n_batches)), int(rng.integers(batch))))
    return (longest // batch, longest % batch), picks


def waveforms(seconds, seed: int, audio: dict, device) -> list:
    """16 kHz signals of the given lengths, as float32 host arrays in
    [-1, 1): Gaussian noise at ``rms`` times a gain per utterance uniform
    in ``gain_db`` decibels, on 16-bit levels (``int16``), as a 16-bit
    corpus decodes. Drawn on ``device`` in one call from the run's
    seed."""
    import torch

    rate = int(audio["sample_rate"])
    n = [int(round(s * rate)) for s in seconds]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "audio"))
    total = sum(n)
    noise = torch.randn(total, generator=gen, device=device)
    lo, hi = audio["gain_db"]
    gains = lo + (hi - lo) * torch.rand(len(n), generator=gen, device=device)
    scale = float(audio["rms"]) * torch.pow(10.0, gains / 20.0)
    noise *= torch.repeat_interleave(
        scale, torch.tensor(n, device=device), output_size=total)
    if audio.get("int16", False):
        noise = torch.clamp(torch.round(noise * 32768.0), -32767.0,
                            32767.0) / 32768.0
    flat = noise.cpu().numpy()
    edges = np.cumsum([0] + n)
    return [flat[edges[i]:edges[i + 1]] for i in range(len(n))]
