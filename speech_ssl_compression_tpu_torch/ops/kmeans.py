"""Mini-batch k-means for HuBERT label generation, on the device.

Port of ``speech_ssl_compression_tpu/ops/kmeans.py``: assignment is one
(B, K) distance matmul, the update a one-hot matmul (Sculley 2010's
mini-batch rule with per-center rate 1/counts), dead centers are reseeded
to the current chunk's farthest rows. The seeding (k-means++ D^2 within the
first chunk) and the reseeding draw from a host ``np.random.default_rng``
stream, as JAX's do, so a seed picks the same rows in both packages. JAX
computes all of it with XLA, not in Pallas; the port uses ``torch.matmul``
with TF32 off.

Layout: features (B, D) rows, centers (K, D); distances use
||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 with the x-norm dropped
(argmin-invariant), so the hot op is x @ centers.T.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import matmul_precision, resolve_device, upload


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, D), (K, D) -> (B,) int32 nearest-center ids; a tie goes to the
    first center, as ``jnp.argmax`` breaks it."""
    with matmul_precision("highest"):
        dots = x @ centers.T
    score = 2.0 * dots - torch.sum(centers.float() ** 2, dim=-1)[None, :]
    return torch.argmax(score, dim=-1).to(torch.int32)


def _minibatch_step(centers, counts, x, valid):
    """One Sculley mini-batch update. x (B, D) f32, valid (B,) bool.

    Per-center learning rate 1/counts (counts accumulate batch
    multiplicities), sklearn's MiniBatchKMeans rule. Returns (centers,
    counts, assignment, batch inertia)."""
    k = centers.shape[0]
    assign = kmeans_assign(x, centers)
    rows = valid.to(torch.float32)
    one_hot = F.one_hot(assign.long(), k).to(torch.float32) * rows[:, None]
    # inertia of this assignment against the centers that produced it
    # (sklearn's definition), before the update below moves them
    diff = x - centers[assign.long()]
    inertia = torch.sum(torch.sum(diff * diff, dim=-1) * rows)
    batch_counts = torch.sum(one_hot, dim=0)
    with matmul_precision("highest"):
        batch_sums = one_hot.T @ x
    new_counts = counts + batch_counts
    safe = torch.clamp_min(new_counts, 1.0)
    centers = centers + (
        batch_sums - batch_counts[:, None] * centers
    ) / safe[:, None]
    return centers, new_counts, assign, inertia


def kmeans_fit(
    rng,
    batches,                 # re-iterable of (B, D) chunks or (x, n_valid)
    k: int,
    *,
    epochs: int = 1,
    reseed_every: int = 50,
    verbose: bool = False,
    device="cuda",
):
    """Mini-batch k-means over an iterable of feature chunks, on ``device``.

    ``batches`` is iterated ``epochs`` times: pass a list or a re-iterable
    object; a one-shot generator raises on the second epoch instead of
    under-training. Chunks may be (B, D) arrays or (x (B, D), n_valid)
    pairs whose rows past n_valid are padding. Init: k-means++ D^2 seeding
    within the first chunk. Centers with no count after ``reseed_every``
    steps are reseeded to the farthest rows of the current chunk.
    ``verbose`` prints the seeding's host seconds, the inertia every 100
    steps and each epoch's seconds (its last step synchronised). Returns
    (centers (K, D) float32 array, mean inertia per row of the last 20
    chunks)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng)
    centers = counts = None
    step = 0
    last_inertia = []  # (inertia tensor, rows): read on the host at the end
    for epoch in range(epochs):
        epoch_chunks = 0
        t_epoch = time.perf_counter()
        for chunk in batches:
            x, n_valid = chunk if isinstance(chunk, tuple) else (chunk, None)
            x = np.asarray(x, np.float32)
            if x.ndim != 2:
                raise ValueError(f"feature chunk must be (B, D), got {x.shape}")
            b = x.shape[0]
            if n_valid is None:
                n_valid = b
            if centers is None:
                t0 = time.perf_counter()
                centers = upload(_dsq_seed(rng, x[:n_valid], k), dev)
                counts = torch.zeros((k,), dtype=torch.float32, device=dev)
                if verbose:
                    print(f"[kmeans] D^2 seeding of {k} centers from "
                          f"{n_valid} rows: {time.perf_counter() - t0:.2f} s "
                          "on the host", flush=True)
            valid = torch.arange(b, device=dev) < n_valid
            centers, counts, _, inertia = _minibatch_step(
                centers, counts, upload(x, dev), valid
            )
            step += 1
            epoch_chunks += 1
            last_inertia = (last_inertia + [(inertia, int(n_valid))])[-20:]
            if reseed_every and step % reseed_every == 0:
                centers, counts = _reseed_dead(
                    rng, centers, counts, x[:n_valid]
                )
            if verbose and step % 100 == 0:
                print(f"[kmeans] step {step}: inertia/row "
                      f"{_mean_inertia(last_inertia):.4f}", flush=True)
        if epoch_chunks == 0:
            raise ValueError(
                "kmeans_fit: no chunks in epoch "
                f"{epoch} — `batches` must be re-iterable (a one-shot "
                "generator exhausts after the first epoch)"
            )
        if verbose:
            inertia = _mean_inertia(last_inertia)  # waits for the device
            print(f"[kmeans] epoch {epoch + 1}/{epochs}: {epoch_chunks} "
                  f"chunks in {time.perf_counter() - t_epoch:.3f} s, "
                  f"inertia/row {inertia:.4f}", flush=True)
    return centers.cpu().numpy(), _mean_inertia(last_inertia)


def _mean_inertia(last_inertia) -> float:
    """JAX's float(inertia) / max(n_valid, 1) per chunk, averaged."""
    values = torch.stack([t for t, _ in last_inertia]).tolist()
    return float(np.mean([v / max(n, 1)
                          for v, (_, n) in zip(values, last_inertia)]))


def _dsq_seed(rng, x, k):
    """k-means++ (D^2) seeding from one chunk, on the host: (k, D) f32
    rows of ``x``."""
    n = x.shape[0]
    if n < k:
        raise ValueError(f"first chunk has {n} rows < k={k}")
    idx = [int(rng.integers(n))]
    d2 = np.sum((x - x[idx[0]]) ** 2, axis=-1)
    for _ in range(k - 1):
        tot = d2.sum()
        if tot <= 0:
            # fewer than k distinct rows in the chunk (e.g. digital
            # silence): uniform draws; the dead-center reseeding resolves
            # the duplicate seeds during fitting
            idx.append(int(rng.integers(n)))
            continue
        p = d2 / tot
        idx.append(int(rng.choice(n, p=p)))
        d2 = np.minimum(d2, np.sum((x - x[idx[-1]]) ** 2, axis=-1))
    return np.asarray(x[idx], np.float32)


def _reseed_dead(rng, centers, counts, x):
    """Replace zero-count centers with the current chunk's farthest rows.

    The host arrays are copies: on a CPU tensor ``.numpy()`` shares the
    tensor's memory, and writing into it would move the caller's
    centers."""
    counts_np = counts.cpu().numpy().copy()
    dead = np.flatnonzero(counts_np == 0)
    if dead.size == 0:
        return centers, counts
    dev = centers.device
    assign = kmeans_assign(upload(x, dev), centers).cpu().numpy()
    centers_np = centers.cpu().numpy().copy()
    d2 = np.sum((x - centers_np[assign]) ** 2, axis=-1)
    n_take = min(dead.size, x.shape[0])
    far = np.argsort(-d2)[:n_take]
    centers_np[dead[:n_take]] = x[far]
    counts_np[dead[:n_take]] = 1.0
    return upload(centers_np, dev), upload(counts_np, dev)
