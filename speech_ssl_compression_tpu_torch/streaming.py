"""Streaming causal MelHuBERT inference with per-layer KV caches.

Port of ``speech_ssl_compression_tpu/streaming.py``: online inference of a
causal MelHuBERT (``attention_type: causal``) as a loop of C-frame chunk
steps against per-layer K/V caches of a fixed capacity.

  * one step runs a chunk of C frames at the shared global offset ``n``:
    each layer writes its new K/V slab into the cache in place
    (``cache[:, :, n:n + C]``) and attends to everything written so far;
  * the outputs equal the full causal forward's: the conv positional
    embedding (kernel K) is the only non-causal op, so emission lags the
    newest frame by K - 1 - K // 2 frames (63 at K = 128, 1.26 s at the
    20 ms frame period), and each chunk's conv runs VALID over a
    (C + K - 1)-frame window, which reproduces the full forward's SamePad
    conv, its zero padding at both stream ends included (the encoder's
    grouped conv, ``ops/grouped_conv.py``, with pad (0, 0));
  * the host featurizer streams the Kaldi fbank: its ops are per frame
    (the chunked frames lie within one float32 ulp of the whole
    utterance's, where the mel product's blocking differs), and the 20 ms
    pair-stacking carry and the zero pad of an odd final frame are handled
    at flush.

The cache attention is plain PyTorch (dense over the cache's capacity, as
JAX's ``jnp.einsum`` is); the steps run eagerly under ``inference_mode``
and :func:`extract.matmul_precision`. Outputs are host numpy float32 (a
bf16 run's are upcast, which is exact).

Typical use::

    s = StreamingCausalExtractor("causal.npz", fp=20,
                                 mean_std_npy_path=".../mean-std.npy")
    for wav_chunk in microphone:
        hidden = s.push_wav(wav_chunk)["last_hidden_state"]  # (n_new, D)
    tail = s.flush()["last_hidden_state"]
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .configs import MelHuBERTConfig
from .extract import (
    PRECISIONS,
    load_any_checkpoint,
    load_mean_std,
    matmul_precision,
    resolve_device,
)
from .models.encoder import encoder_layer_forward, layer_norm, pos_conv_weight
from .models.melhubert import pre_project
from .ops.activations import at_least_f32, gelu
from .ops.attention import output_projection, project_to_heads
from .ops.fbank import (
    kaldi_fbank_np,
    normalize_fbank,
    num_frames,
    stack_frame_pairs_np,
)
from .ops.flash_attention import NEG_INF
from .ops.grouped_conv import grouped_conv1d
from .utils.weights import load_model


def _cached_self_attn(h, attn, cache, n: int, start, *, num_heads: int,
                      head_dim: int, window: Optional[int] = None):
    """Causal self-attention of a (B, C, D) chunk at global offset ``n``
    against a (B, H, cap, d) K/V cache. Returns (out, context); the new
    keys and values are written into ``cache`` in place.

    They are written first; the causal mask kv_pos <= n + q_row then covers
    everything: unwritten capacity and stale rows past the write lie at
    positions > n + C - 1. ``start`` (B,) is each row's stream origin:
    cache positions below it belong to a slot's previous stream and are
    masked the same way.

    ``window`` turns the cache into a ring over the last ``window`` frames:
    the slab is written at n mod cap (never across the end: n advances by
    C a step and cap is a multiple of C holding window + C), slot p holds
    global frame f(p), the largest f <= n + C - 1 with f = p (mod cap), and
    a query g attends to [max(start, g - window + 1), g].

    Scores and the context are taken in float32 from operands upcast
    (exactly) from the compute dtype, the probabilities rounded to it
    before the context, where JAX's ``preferred_element_type=float32``
    products round."""
    b, c, _ = h.shape
    q = project_to_heads(h, attn.q_proj, num_heads, head_dim)
    k_cache, v_cache = cache["k"], cache["v"]
    cap = k_cache.shape[2]
    wr = n if window is None else n % cap
    k_cache[:, :, wr:wr + c] = project_to_heads(h, attn.k_proj, num_heads,
                                                head_dim)
    v_cache[:, :, wr:wr + c] = project_to_heads(h, attn.v_proj, num_heads,
                                                head_dim)
    # 1/sqrt(d) rounded to the compute dtype first, as JAX's weak scalar
    scale = torch.reciprocal(torch.sqrt(torch.tensor(float(head_dim),
                                                     dtype=q.dtype)))
    s = torch.matmul(at_least_f32(q * scale),
                     at_least_f32(k_cache).transpose(-1, -2))  # (B,H,C,cap)
    kv_pos = torch.arange(cap, device=h.device)
    g = torch.arange(n, n + c, device=h.device)  # global query positions
    if window is not None:
        # floor division: the numerator is negative for slots not written
        # since the clock's first pass
        kv_pos = kv_pos + torch.div(n + c - 1 - kv_pos, cap,
                                    rounding_mode="floor") * cap
    allowed = ((kv_pos[None, None, :] <= g[None, :, None])
               & (kv_pos[None, None, :] >= start[:, None, None]))
    if window is not None:
        allowed &= kv_pos[None, None, :] > g[None, :, None] - window
    # NEG_INF is finite: a fully masked row softmaxes to uniform, not NaN
    s = s.masked_fill(~allowed[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.matmul(at_least_f32(p.to(h.dtype)),
                       at_least_f32(v_cache)).to(h.dtype)  # (B, H, C, d)
    return output_projection(ctx, attn.out_proj), ctx


def _stream_step(model, cfg, window, feat_win, valid_win, caches, n: int,
                 start):
    """One step: ``feat_win`` (B, C + K - 1, F) model-input features around
    the C frames emitted, ``valid_win`` (B, C + K - 1) bool (False outside
    the real stream), ``caches`` per layer, ``n`` the shared global index of
    the first emitted frame, ``start`` (B,) each row's stream origin,
    ``window`` the ring's extent or None. Returns (hidden, layer_hiddens,
    pre_feat)."""
    x = pre_project(model, feat_win)
    # the full forward zeroes padded positions before the pos-conv
    # (encoder_prologue); the stream's edges reproduce that zero context
    x = x.masked_fill(~valid_win[:, :, None], 0.0)

    enc = model.encoder
    left = cfg.conv_pos // 2
    c = x.shape[1] - cfg.conv_pos + 1
    pc = enc.pos_conv[0]
    # VALID conv over the window = the full forward's SamePad output for
    # exactly these C frames (the even-K crop included: output t reads
    # inputs [t - K // 2, t + K - 1 - K // 2], the window's whole extent)
    pos = grouped_conv1d(x, pos_conv_weight(pc).to(x.dtype).permute(2, 1, 0),
                         cfg.conv_pos_groups, (0, 0)).to(x.dtype)
    pos = gelu(pos + pc.bias)

    pre_feat = x[:, left:left + c]
    h = pre_feat + pos
    if not cfg.layer_norm_first:
        h = layer_norm(h, enc.layer_norm)

    hiddens = []
    for i, layer in enumerate(enc.layers):
        attn_fn = functools.partial(
            _cached_self_attn, attn=layer.self_attn, cache=caches[i], n=n,
            start=start, num_heads=cfg.encoder_attention_heads[i],
            head_dim=cfg.head_dim, window=window,
        )
        h, _ = encoder_layer_forward(
            h, layer, layer_norm_first=cfg.layer_norm_first,
            activation_fn=cfg.activation_fn, attn_fn=attn_fn,
        )
        hiddens.append(h)
    final = layer_norm(h, enc.layer_norm) if cfg.layer_norm_first else h
    return final, hiddens, pre_feat


class _StreamFeaturizer:
    """Host streaming Kaldi featurizer: 16 kHz waveform chunks in,
    normalized model-input frames out (pair-stacked for fp=20). The fbank
    is per frame, so the chunked output is the whole utterance's (to one
    float32 ulp); ``flush`` zero-pads the missing half of an odd final
    pair."""

    def __init__(self, fp: int, mean, std, precision: str):
        self.fp = fp
        self.mean, self.std = mean, std
        self.precision = precision
        self.reset()

    def reset(self):
        self._audio_tail = np.zeros((0,), np.float32)
        self._mel_carry = np.zeros((0, 40), np.float32)

    @property
    def feat_dim(self) -> int:
        return 80 if self.fp == 20 else 40

    def push(self, wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32).reshape(-1)
        buf = np.concatenate([self._audio_tail, wav])
        m = num_frames(len(buf))
        if m == 0:
            self._audio_tail = buf
            return np.zeros((0, self.feat_dim), np.float32)
        dtype = np.float64 if self.precision == "high" else np.float32
        mel = kaldi_fbank_np(buf.astype(dtype) * (2 ** 15), dtype=dtype)
        # frame t covers samples [160 t, 160 t + 400): keep from 160 m on
        self._audio_tail = buf[160 * m:]
        mel = normalize_fbank(mel, self.mean, self.std).astype(np.float32)
        return self._stack(mel, final=False)

    def flush(self) -> np.ndarray:
        # audio shorter than one 400-sample window makes no frame
        # (snip_edges), as in whole-utterance extraction
        self._audio_tail = self._audio_tail[:0]
        return self._stack(np.zeros((0, 40), np.float32), final=True)

    def _stack(self, mel: np.ndarray, final: bool) -> np.ndarray:
        if self.fp != 20:
            return mel
        mel = np.concatenate([self._mel_carry, mel], axis=0)
        n_pairs = len(mel) // 2
        stacked = stack_frame_pairs_np(mel[: 2 * n_pairs])
        self._mel_carry = mel[2 * n_pairs:]
        if final and len(self._mel_carry):
            stacked = np.concatenate(
                [stacked, stack_frame_pairs_np(self._mel_carry)], axis=0
            )
            self._mel_carry = self._mel_carry[:0]
        return stacked


def _init_stream_common(self, ckpt, params, cfg, fp, mean_std_npy_path,
                        chunk_frames, dtype, precision, fbank_precision,
                        get_hidden, window, device):
    """Constructor body the two extractors share: the device, the weights
    (``ckpt`` through :func:`extract.load_any_checkpoint`, or ``params``, a
    JAX-layout numpy tree, with ``cfg``) loaded by ``load_model`` and cast
    to ``dtype``, the checks, the mean and std."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}")
    self.device = resolve_device(device)
    if ckpt is not None:
        params, cfg, _ = load_any_checkpoint(ckpt)
    if params is None or cfg is None:
        raise ValueError("pass either ckpt= or (params= and cfg=)")
    _check_streamable(cfg)

    self.cfg = cfg
    self.fp = fp
    self.chunk = int(chunk_frames)
    self.dtype = dtype
    self.matmul_precision = precision
    self.get_hidden = get_hidden
    self.fbank_precision = fbank_precision
    self.window = window
    self.model = load_model(params, cfg).to(self.device, dtype)
    self.model.eval().requires_grad_(False)
    if mean_std_npy_path is not None:
        self.mean, self.std = load_mean_std(mean_std_npy_path)
    else:
        self.mean, self.std = np.zeros(40), np.ones(40)
    k = cfg.conv_pos
    self._left = k // 2
    self._right = k - 1 - self._left


def _check_streamable(cfg: MelHuBERTConfig):
    if cfg.attention_type != "causal":
        raise ValueError(
            "streaming requires attention_type: causal (got "
            f"{cfg.attention_type!r}); a bidirectional model's outputs "
            "depend on future frames"
        )
    if cfg.pos_emb_type != "conv" or getattr(cfg, "pos_conv_depth", 1) != 1:
        raise NotImplementedError(
            "streaming supports the depth-1 conv positional embedding"
        )
    if cfg.encoder_layers <= 0:
        raise ValueError("streaming needs at least one encoder layer")


def _new_caches(self, rows: int) -> list:
    """Zeroed per-layer {"k", "v"} caches (rows, H_i, cap, d)."""
    cfg = self.cfg
    with torch.inference_mode():
        return [
            {name: torch.zeros((rows, cfg.encoder_attention_heads[i],
                                self._cap, cfg.head_dim), dtype=self.dtype,
                               device=self.device)
             for name in ("k", "v")}
            for i in range(cfg.encoder_layers)
        ]


def _run_step(self, feat_win: np.ndarray, valid: np.ndarray, n: int,
              start: np.ndarray):
    """One :func:`_stream_step` on the device from host arrays."""
    dev = self.device
    with matmul_precision(self.matmul_precision), torch.inference_mode():
        return _stream_step(
            self.model, self.cfg, self.window,
            torch.from_numpy(feat_win).to(dev, self.dtype),
            torch.from_numpy(valid).to(dev), self._caches, n,
            torch.from_numpy(start).to(dev),
        )


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


class StreamingCausalExtractor:
    """Online causal feature extraction in constant-shape chunk steps.

    Parameters mirror :class:`extract.MelHuBERTExtractor`; the model must
    have ``attention_type: causal`` (the reference's option at
    model.py:121-132): a bidirectional model cannot stream without
    changing its outputs, so anything else raises. ``device`` is "cuda"
    unless the caller asks for the CPU; without CUDA, "cuda" raises.

    ``push_wav`` / ``push_feat`` buffer input and run as many C-frame steps
    as the conv lookahead allows, returning the newly emitted frames;
    ``flush`` drains the tail (zero right context, as in the full forward)
    and finalizes the stream: further pushes raise until ``reset()`` (the
    offset after a flush may lie mid-chunk, where a resumed step would
    overlap the cache's last slab). Outputs are bitwise the same however
    the input is cut into pushes, and match the full causal forward to
    float tolerance.
    """

    def __init__(
        self,
        ckpt: Optional[str] = None,
        *,
        params: Optional[dict] = None,
        cfg: Optional[MelHuBERTConfig] = None,
        fp: int = 20,
        mean_std_npy_path: Optional[str] = None,
        chunk_frames: int = 128,
        max_frames: int = 3072,
        dtype: torch.dtype = torch.float32,
        matmul_precision: str = "highest",
        fbank_precision: str = "fast",
        get_hidden: bool = False,
        device="cuda",
    ):
        _init_stream_common(
            self, ckpt, params, cfg, fp, mean_std_npy_path, chunk_frames,
            dtype, matmul_precision, fbank_precision, get_hidden, None,
            device,
        )
        self.max_frames = int(max_frames)
        # capacity rounded up to whole chunks: every step writes a full
        # C-frame slab at the current offset, which must stay in bounds for
        # any stream of up to max_frames real frames
        self._cap = -(-self.max_frames // self.chunk) * self.chunk
        self.reset()

    # ------------------------------------------------------------------ #

    def reset(self):
        self._caches = _new_caches(self, 1)
        feat_dim = self.cfg.feat_emb_dim
        self._ctx = np.zeros((self._left, feat_dim), np.float32)
        self._pending = np.zeros((0, feat_dim), np.float32)
        self._emitted = 0   # frames already run through the encoder
        self._total = 0     # real feature frames received
        self._finished = False
        self._feat = _StreamFeaturizer(
            self.fp, self.mean, self.std, self.fbank_precision
        )

    # ------------------------------------------------------------------ #
    # feature-level streaming

    def push_feat(self, feat: np.ndarray) -> dict:
        """feat: (m, feat_emb_dim) final model-input frames (normalized;
        already pair-stacked for fp=20)."""
        if self._finished:
            raise ValueError(
                "stream was flushed; reset() to start a new one"
            )
        feat = np.asarray(feat, np.float32)
        if feat.ndim != 2 or feat.shape[1] != self.cfg.feat_emb_dim:
            raise ValueError(
                f"expected (m, {self.cfg.feat_emb_dim}) features, got "
                f"{feat.shape}"
            )
        # checked at buffer time: nothing is consumed on failure, and the
        # drain loop never raises after emitting part of a push
        if self._total + len(feat) > self.max_frames:
            raise ValueError(
                f"stream ({self._total + len(feat)} frames) exceeds "
                f"max_frames={self.max_frames}; raise max_frames or reset()"
            )
        self._pending = np.concatenate([self._pending, feat], axis=0)
        self._total += len(feat)
        return self._drain(final=False)

    def flush(self) -> dict:
        """Emit every remaining frame (zero right context at the stream's
        end, as the full forward pads) and finalize the stream
        (idempotent; reset() starts a new one)."""
        if self._finished:
            return _empty_out(self.cfg, self.get_hidden)
        feat = self._feat.flush()
        out = (
            self.push_feat(feat) if len(feat)
            else _empty_out(self.cfg, self.get_hidden)
        )
        tail = self._drain(final=True)
        self._finished = True
        return _merge_out(out, tail)

    # ------------------------------------------------------------------ #
    # waveform-level streaming

    def push_wav(self, wav: np.ndarray) -> dict:
        """wav: (n,) float32 in [-1, 1] at 16 kHz, any chunk size."""
        if self._finished:
            raise ValueError(
                "stream was flushed; reset() to start a new one"
            )
        feat = self._feat.push(wav)
        if len(feat) == 0:
            return _empty_out(self.cfg, self.get_hidden)
        return self.push_feat(feat)

    # ------------------------------------------------------------------ #

    def _drain(self, final: bool) -> dict:
        c = self.chunk
        outs = []
        while True:
            if final:
                if self._emitted >= self._total:
                    break
            elif len(self._pending) < c + self._right:
                break
            # an invariant, not a user-facing check (push_feat checks at
            # buffer time): total <= max_frames and the finalizing flush
            # keep emitted chunk-aligned while draining, so the slab write
            # [emitted, emitted + c) stays within the capacity
            assert self._emitted + c <= self._cap, (
                self._emitted, c, self._cap
            )
            need = c + self._right
            window = self._pending[:need]
            if len(window) < need:
                pad = np.zeros((need - len(window), window.shape[1]),
                               np.float32)
                window = np.concatenate([window, pad], axis=0)
            feat_win = np.concatenate([self._ctx, window], axis=0)[None]
            pos = self._emitted - self._left + np.arange(feat_win.shape[1])
            valid = (pos >= 0) & (pos < self._total)

            hidden, hiddens, pre_feat = _run_step(
                self, feat_win, valid[None], self._emitted,
                np.zeros((1,), np.int64),
            )
            n_real = min(c, self._total - self._emitted)
            entry = {"last_hidden_state": _host(hidden[0, :n_real])}
            if self.get_hidden:
                entry["hidden_states"] = [_host(pre_feat[0, :n_real])] + [
                    _host(h[0, :n_real]) for h in hiddens
                ]
            outs.append(entry)

            # the next window's left context: the last `left` frames of
            # the chunk just emitted (zeros past the stream's end are
            # masked by the validity positions)
            self._ctx = feat_win[0, c:c + self._left].copy()
            self._pending = self._pending[c:]
            self._emitted += n_real
        return _merge_out(_empty_out(self.cfg, self.get_hidden), *outs)


class StreamingCausalBatchExtractor:
    """N concurrent causal streams served in lockstep chunk steps.

    One step advances every slot by the same C-frame window against a
    batched (N, H, cap, d) KV cache: N realtime streams cost one chunk step
    instead of N. Lockstep is the natural shape of realtime serving: every
    live audio source makes frames at the same wall rate.

    Per slot the semantics are :class:`StreamingCausalExtractor`'s (the
    same step): pushes buffer on the host, ``poll()`` runs as many lockstep
    steps as every unfinished slot's buffered right context allows (a
    lagging live stream gates the batch, by design), ``finish(i)`` marks a
    stream ended so that its tail drains with zero right context, and
    ``open_stream(i)`` re-arms a finished, fully drained slot for a new
    stream at the current physical offset (continuous batching): the
    slot's stale cache rows are masked by the per-row ``start`` floor, and
    since the conv positional embedding is relative, a stream starting at
    offset s gives the outputs of one starting at 0.

    ``max_frames`` bounds the shared physical timeline (the longest-running
    slot), not each stream: reused slots ride the same clock. When it is
    used up, ``reset()`` starts a new one (drain the live streams first).

    ``window_frames`` switches to unbounded always-on serving at constant
    memory: the KV cache becomes a ring over the last ``window_frames``
    frames and attention is windowed to them (each deeper layer's
    receptive field grows by one window, Transformer-XL style; with a
    window no shorter than any stream it is the full causal computation).
    ``max_frames`` is then ignored. The shared clock is a Python int here,
    where JAX's is an int32.

    Every slot starts live: with fewer streams than ``batch``, ``finish(i)``
    the unused slots so that they do not gate ``poll()`` (an empty finished
    slot costs nothing and can be ``open_stream``-ed later).
    """

    def __init__(
        self,
        ckpt: Optional[str] = None,
        *,
        params: Optional[dict] = None,
        cfg: Optional[MelHuBERTConfig] = None,
        batch: int = 8,
        fp: int = 20,
        mean_std_npy_path: Optional[str] = None,
        chunk_frames: int = 128,
        max_frames: int = 3072,
        window_frames: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        matmul_precision: str = "highest",
        fbank_precision: str = "fast",
        get_hidden: bool = False,
        device="cuda",
    ):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        window = None if window_frames is None else int(window_frames)
        if window is not None and window < 1:
            raise ValueError(f"window_frames must be >= 1, got {window}")
        _init_stream_common(
            self, ckpt, params, cfg, fp, mean_std_npy_path, chunk_frames,
            dtype, matmul_precision, fbank_precision, get_hidden, window,
            device,
        )
        self.batch = int(batch)
        if self.window is None:
            self.max_frames = int(max_frames)
            self._cap = -(-self.max_frames // self.chunk) * self.chunk
        else:
            # ring capacity: whole chunks holding window + one chunk, so
            # the slab write never wraps and the oldest frame a query may
            # attend (g - window + 1) is not yet overwritten
            self.max_frames = None
            self._cap = (
                -(-(self.window + self.chunk) // self.chunk) * self.chunk
            )
        self._featurizers = [
            _StreamFeaturizer(fp, self.mean, self.std, fbank_precision)
            for _ in range(self.batch)
        ]
        self.reset()

    # ------------------------------------------------------------------ #

    def reset(self):
        nb = self.batch
        self._caches = _new_caches(self, nb)
        feat_dim = self.cfg.feat_emb_dim
        self._ctx = np.zeros((nb, self._left, feat_dim), np.float32)
        self._pending = [
            np.zeros((0, feat_dim), np.float32) for _ in range(nb)
        ]
        self._emitted = 0                        # shared physical offset
        self._start = np.zeros(nb, np.int64)     # per-slot stream origin
        self._total = np.zeros(nb, np.int64)     # per-slot physical end
        self._finished = np.zeros(nb, bool)
        for f in self._featurizers:
            f.reset()

    def _check_slot(self, slot: int):
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} out of range [0, {self.batch})")

    # ------------------------------------------------------------------ #
    # per-slot input

    def push_feat(self, slot: int, feat: np.ndarray) -> None:
        """Buffer (m, feat_emb_dim) model-input frames for one slot
        (normalized; already pair-stacked for fp=20). ``poll()`` advances
        the batch."""
        self._check_slot(slot)
        if self._finished[slot]:
            raise ValueError(
                f"slot {slot} is finished; open_stream({slot}) first"
            )
        feat = np.asarray(feat, np.float32)
        if feat.ndim != 2 or feat.shape[1] != self.cfg.feat_emb_dim:
            raise ValueError(
                f"expected (m, {self.cfg.feat_emb_dim}) features, got "
                f"{feat.shape}"
            )
        # checked at buffer time: nothing is consumed on failure, and
        # poll() never raises after running part of its steps (the ring
        # is unbounded: no check)
        if (self.window is None
                and self._total[slot] + len(feat) > self.max_frames):
            raise ValueError(
                f"slot {slot} would end at frame "
                f"{self._total[slot] + len(feat)} > "
                f"max_frames={self.max_frames} (the SHARED timeline); "
                "raise max_frames, use window_frames=, or reset()"
            )
        self._pending[slot] = np.concatenate(
            [self._pending[slot], feat], axis=0
        )
        self._total[slot] += len(feat)

    def push_wav(self, slot: int, wav: np.ndarray) -> None:
        """Buffer a 16 kHz float32 waveform chunk for one slot."""
        self._check_slot(slot)
        feat = self._featurizers[slot].push(wav)
        if len(feat):
            self.push_feat(slot, feat)

    def finish(self, slot: int) -> None:
        """Mark a slot's stream ended: its featurizer's tail is flushed and
        its remaining frames drain with zero right context on the next
        ``poll()`` calls (the full forward's edge)."""
        self._check_slot(slot)
        if self._finished[slot]:
            return
        feat = self._featurizers[slot].flush()
        if len(feat):
            self.push_feat(slot, feat)
        self._finished[slot] = True

    def open_stream(self, slot: int) -> None:
        """Re-arm a finished, fully drained slot for a new stream starting
        at the current physical offset (continuous batching)."""
        self._check_slot(slot)
        if not self._finished[slot]:
            raise ValueError(f"slot {slot} is still streaming; finish() it")
        if self._total[slot] > self._emitted:
            raise ValueError(
                f"slot {slot} has {self._total[slot] - self._emitted} "
                "undrained frames; poll() until empty before reusing"
            )
        self._start[slot] = self._total[slot] = self._emitted
        self._finished[slot] = False
        self._pending[slot] = self._pending[slot][:0]
        self._ctx[slot] = 0.0
        self._featurizers[slot].reset()

    def slot_finished(self, slot: int) -> bool:
        """True once a slot is finished and fully drained (reusable)."""
        self._check_slot(slot)
        return bool(
            self._finished[slot] and self._total[slot] <= self._emitted
        )

    # ------------------------------------------------------------------ #
    # lockstep advance

    def _ready(self) -> bool:
        if not (self._total > self._emitted).any():
            return False  # nothing new to emit anywhere
        need = self.chunk + self._right
        for i in range(self.batch):
            if (not self._finished[i]
                    and self._total[i] - self._emitted < need):
                return False  # a live stream has not buffered its window
        return True

    def poll(self) -> list:
        """Run as many lockstep steps as buffering allows; return one dict
        per slot with the frames newly emitted for it (possibly 0 rows)."""
        cfg, c = self.cfg, self.chunk
        outs = [[_empty_out(cfg, self.get_hidden)] for _ in range(self.batch)]
        while self._ready():
            if self.window is None:
                # an invariant, not a user-facing check (push_feat bounds
                # every total at buffer time): emitted stays chunk-aligned
                # and below some total <= max_frames <= cap
                assert self._emitted + c <= self._cap, (
                    self._emitted, c, self._cap
                )
            need = c + self._right
            window = np.zeros(
                (self.batch, need, cfg.feat_emb_dim), np.float32
            )
            for i in range(self.batch):
                w = self._pending[i][:need]
                window[i, :len(w)] = w
            feat_win = np.concatenate([self._ctx, window], axis=1)
            pos = (self._emitted - self._left) + np.arange(feat_win.shape[1])
            valid = (
                (pos[None, :] >= self._start[:, None])
                & (pos[None, :] < self._total[:, None])
            )

            hidden, hiddens, pre_feat = _run_step(
                self, feat_win, valid, self._emitted, self._start,
            )
            hidden = _host(hidden)
            if self.get_hidden:
                pre_feat = _host(pre_feat)
                hiddens = [_host(h) for h in hiddens]
            for i in range(self.batch):
                n_real = int(
                    min(c, max(0, int(self._total[i]) - self._emitted))
                )
                entry = {"last_hidden_state": hidden[i, :n_real]}
                if self.get_hidden:
                    entry["hidden_states"] = [pre_feat[i, :n_real]] + [
                        h[i, :n_real] for h in hiddens
                    ]
                outs[i].append(entry)
                self._pending[i] = self._pending[i][c:]
            self._ctx = feat_win[:, c:c + self._left].copy()
            self._emitted += c
        return [_merge_out(*o) for o in outs]

    def flush(self) -> list:
        """Finish every slot and drain all remaining frames."""
        for i in range(self.batch):
            self.finish(i)
        return self.poll()


def _empty_out(cfg, get_hidden: bool) -> dict:
    d = cfg.encoder_embed_dim
    out = {"last_hidden_state": np.zeros((0, d), np.float32)}
    if get_hidden:
        out["hidden_states"] = [
            np.zeros((0, d), np.float32)
            for _ in range(cfg.encoder_layers + 1)
        ]
    return out


def _merge_out(*outs: dict) -> dict:
    """``outs`` concatenated along the frames, each array copied once."""
    out = {
        "last_hidden_state": np.concatenate(
            [o["last_hidden_state"] for o in outs], axis=0
        )
    }
    if "hidden_states" in outs[0]:
        out["hidden_states"] = [
            np.concatenate(layer, axis=0)
            for layer in zip(*(o["hidden_states"] for o in outs))
        ]
    return out
