"""Sequence-parallel extraction and distillation of the port
(``parallel/seqpar.py``, ``MelHuBERTExtractor.forward_seqpar``) on 2 and
4 CPU ranks, against the JAX package's ``parallel/seqpar.py`` on its
virtual CPU mesh of as many devices and against its 1-device forward.

The ranks are gloo subprocesses that import nothing of JAX; they start
once per world size for the whole module (``ranks``) and run every case
on weights JAX wrote (``utils/checkpoint.py``). Bars are JAX's own
tests': max|d| / mean|ref| < 1e-4 on valid frames for the forward, loss
rel 1e-5 and every gradient rel. L2 1e-4 for the distill step (a leaf
whose reference is ~0 by symmetry, the k_proj biases, is taken against the
norm of all leaves: ``tests/test_torch_parallel.py``)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.compress.distillation import (
    distillation_loss,
)
from speech_ssl_compression_tpu.configs import (
    MelHuBERTConfig as JaxMelHuBERTConfig,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models.melhubert import melhubert_forward
from speech_ssl_compression_tpu.parallel import make_mesh
from speech_ssl_compression_tpu.parallel.seqpar import (
    make_melhubert_seqpar_distill_step,
    melhubert_extract_seqpar,
)
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
from speech_ssl_compression_tpu_torch.parallel import seqpar as tseqpar
from speech_ssl_compression_tpu_torch.utils.weights import load_model
from tests.test_torch_parallel import (
    REPO,
    _assert_within_rel_l2,
    _env,
    _free_port,
)
from speech_ssl_compression_tpu_torch.utils.torch_convert import (
    melhubert_state_dict_to_params,
)

FWD_BAR = 1e-4     # max|d| / mean|ref| on valid frames
LOSS_RTOL = 1e-5
GRAD_BAR = 1e-4    # rel. L2, each gradient

BASE = dict(feat_emb_dim=40, encoder_layers=2, encoder_embed_dim=64,
            encoder_attention_heads=4, head_dim=16,
            encoder_ffn_embed_dim=128, num_cluster=32, conv_pos=16,
            conv_pos_groups=4, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, encoder_layerdrop=0.0, mask_prob=0.65,
            mask_length=4, learnable_mask_emb=True)
STUDENT = dict(BASE, encoder_layers=1)
# (T, valid lengths): a whole shard set, and T = 900 (no multiple of
# n x 128) with a shorter valid length, as tests/test_seqpar.py:68-97
EXTRACT = {"full": (1024, (1024,)), "odd": (900, (700,))}
DISTILL_T, DISTILL_LENGTHS = 1024, (1024, 900)
TEMPERATURE, ALPHA = 2.0, 0.7

WORKER = r'''
import json, os, sys
repo, rank, world, port, spec = sys.argv[1:6]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                  WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.parallel.mesh import make_mesh
from speech_ssl_compression_tpu_torch.parallel.multihost import initialize
from speech_ssl_compression_tpu_torch.parallel.seqpar import (
    make_melhubert_seqpar_distill_step, melhubert_extract_seqpar)
from speech_ssl_compression_tpu_torch.utils.checkpoint import load_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import load_model

spec = json.load(open(spec))
initialize(backend="gloo", device_type="cpu")
mesh = make_mesh()
data = dict(np.load(spec["data"]))
out = {}

def model(ckpt, cfg):
    return load_model(load_checkpoint(ckpt, load_opt=False)["params"],
                      MelHuBERTConfig.from_dict(cfg))

teacher = model(spec["teacher"], spec["base"])
with torch.no_grad():
    for case in spec["extract"]:
        out[f"extract_{case}"] = melhubert_extract_seqpar(
            teacher, torch.from_numpy(data[f"feat_{case}"]),
            torch.from_numpy(data[f"pad_{case}"]), mesh).numpy()
ext = MelHuBERTExtractor(spec["teacher"], fp=10, device="cpu")
for feat in ("host", "device"):
    got = ext.forward_seqpar(data["wav"], featurizer=feat)
    out[f"seqpar_{feat}"] = got["last_hidden_state"].numpy()
    out[f"forward_{feat}"] = ext.forward(
        [data["wav"]], featurizer=feat)["last_hidden_state"].numpy()
    out[f"lengths_{feat}"] = np.asarray(got["lengths"])
student = model(spec["student"], spec["student_cfg"])
params = dict(student.named_parameters())
batch = {k: torch.from_numpy(data[k]) for k in ("feat", "pad_mask", "label")}
for loss_type in ("masked", "nomasked"):
    step = make_melhubert_seqpar_distill_step(
        teacher, student, mesh, temperature=spec["temperature"],
        alpha=spec["alpha"], loss_type=loss_type)
    loss, grads, logs = step(params, batch, None, mask_indices=(
        torch.from_numpy(data["mask"]) if loss_type == "masked" else None))
    out[f"{loss_type}_loss"] = np.float64(loss)
    for k, g in zip(params, grads):
        out[f"{loss_type}/{k}"] = g.numpy()
if rank == "0":
    np.savez(spec["out"], **out)
'''


def _jax_cfg(d):
    return JaxMelHuBERTConfig.from_dict(d)


def _data(seed=3):
    rng = np.random.default_rng(seed)
    out = {}
    for case, (t, lengths) in EXTRACT.items():
        out[f"feat_{case}"] = rng.standard_normal(
            (len(lengths), t, BASE["feat_emb_dim"])).astype(np.float32)
        out[f"pad_{case}"] = (np.arange(t)[None, :] < np.asarray(
            lengths)[:, None]).astype(np.float32)
    b, t = len(DISTILL_LENGTHS), DISTILL_T
    out["feat"] = rng.standard_normal(
        (b, t, BASE["feat_emb_dim"])).astype(np.float32)
    out["pad_mask"] = (np.arange(t)[None, :] < np.asarray(
        DISTILL_LENGTHS)[:, None]).astype(np.float32)
    label = rng.integers(0, BASE["num_cluster"], (b, t)).astype(np.int64)
    label[0, 5] = -100
    out["label"] = label
    out["mask"] = (rng.random((b, t)) < 0.3) & out["pad_mask"].astype(bool)
    out["wav"] = (rng.standard_normal(16000 * 4) * 0.05).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The weights, the inputs, and each world size's results from its
    ranks: {"params", "student", "data", 2: {...}, 4: {...}}."""
    root = tmp_path_factory.mktemp("seqpar")
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(0), _jax_cfg(BASE)))
    student = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(1), _jax_cfg(STUDENT)))
    jax_save_checkpoint(str(root / "teacher.npz"), params,
                        meta={"Upstream_Config": {"melhubert": BASE}})
    jax_save_checkpoint(str(root / "student.npz"), student,
                        meta={"Upstream_Config": {"melhubert": STUDENT}})
    data = _data()
    np.savez(root / "data.npz", **data)
    got = {"params": params, "student": student, "data": data}
    for world in (2, 4):
        spec = root / f"spec{world}.json"
        spec.write_text(json.dumps(dict(
            data=str(root / "data.npz"), teacher=str(root / "teacher.npz"),
            student=str(root / "student.npz"), base=BASE,
            student_cfg=STUDENT, extract=list(EXTRACT),
            temperature=TEMPERATURE, alpha=ALPHA,
            out=str(root / f"out{world}.npz"))))
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(REPO), str(r), str(world),
             port, str(spec)], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env())
            for r in range(world)]
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
        got[world] = dict(np.load(root / f"out{world}.npz"))
    return got


def _fwd_err(got, ref, valid):
    v = np.asarray(valid, bool)[..., None]
    ref = np.asarray(ref)
    return float(np.abs(np.where(v, got - ref, 0.0)).max()
                 / np.abs(ref[np.broadcast_to(v, ref.shape)]).mean())


@pytest.mark.parametrize("case", list(EXTRACT))
@pytest.mark.parametrize("world", [2, 4])
def test_extract_matches_jax_seqpar_and_forward(ranks, world, case):
    """The port on ``world`` ranks against JAX's seqpar on a mesh of as
    many devices and JAX's 1-device forward, on the valid frames."""
    cfg = _jax_cfg(BASE)
    feat = jnp.asarray(ranks["data"][f"feat_{case}"])
    pad = jnp.asarray(ranks["data"][f"pad_{case}"])
    want = np.asarray(melhubert_extract_seqpar(
        ranks["params"], cfg, feat, pad, make_mesh(world),
        attn_impl="dense", precision="highest"))
    ref = np.asarray(melhubert_forward(
        ranks["params"], cfg, feat, pad, mask=False, no_pred=True,
        attn_impl="dense")["hidden"])
    got = ranks[world][f"extract_{case}"]
    assert got.shape == want.shape == ref.shape
    valid = ranks["data"][f"pad_{case}"]
    assert _fwd_err(got, want, valid) < FWD_BAR
    assert _fwd_err(got, ref, valid) < FWD_BAR


@pytest.mark.parametrize("featurizer", ["host", "device"])
@pytest.mark.parametrize("world", [2, 4])
def test_forward_seqpar_matches_forward(ranks, world, featurizer):
    """The extractor's forward_seqpar on the ranks equals its own forward
    (tests/test_seqpar.py:147), with both featurizers."""
    got = ranks[world][f"seqpar_{featurizer}"]
    ref = ranks[world][f"forward_{featurizer}"]
    assert got.shape == ref.shape
    n = int(ranks[world][f"lengths_{featurizer}"][0])
    assert _fwd_err(got[:, :n], ref[:, :n], np.ones((1, n))) < FWD_BAR


@pytest.mark.parametrize("loss_type", ["masked", "nomasked"])
@pytest.mark.parametrize("world", [2, 4])
def test_distill_step_matches_jax(ranks, world, loss_type):
    """The seqpar distill step against JAX's on a mesh of ``world``
    devices, the span mask injected (tests/test_seqpar.py:183-230)."""
    data = ranks["data"]
    tcfg, scfg = _jax_cfg(BASE), _jax_cfg(STUDENT)
    masked = loss_type == "masked"
    b, t = data["pad_mask"].shape
    batch = {"feat": jnp.asarray(data["feat"]),
             "pad_mask": jnp.asarray(data["pad_mask"]),
             "label": jnp.asarray(data["label"], jnp.int32),
             "mask_indices": jnp.asarray(data["mask"] if masked
                                         else np.zeros((b, t), bool))}
    step = make_melhubert_seqpar_distill_step(
        tcfg, scfg, make_mesh(world), axis="data", temperature=TEMPERATURE,
        alpha=ALPHA, loss_type=loss_type, attn_impl="dense",
        precision="highest")
    loss, grads, _ = step(ranks["student"], ranks["params"], batch, None)
    got = ranks[world]
    assert abs(float(got[f"{loss_type}_loss"]) - float(loss)) <= (
        LOSS_RTOL * abs(float(loss)))
    named = {k[len(loss_type) + 1:]: torch.from_numpy(v)
             for k, v in got.items() if k.startswith(f"{loss_type}/")}
    tree = melhubert_state_dict_to_params(named, keep_masks=False)[0]
    _assert_within_rel_l2(tree, jax.tree.map(np.asarray, grads), GRAD_BAR)
    # and JAX's 1-device distillation loss on the same mask
    t_out = melhubert_forward(
        ranks["params"], tcfg, batch["feat"], batch["pad_mask"],
        mask=masked, teacher_mask_indices=batch["mask_indices"]
        if masked else None, deterministic=True, attn_impl="dense")
    s_out = melhubert_forward(
        ranks["student"], scfg, batch["feat"], batch["pad_mask"],
        mask=masked, teacher_mask_indices=t_out["mask_indices"],
        deterministic=True, attn_impl="dense")
    ref, _ = distillation_loss(s_out, t_out, batch["label"],
                               batch["pad_mask"], temperature=TEMPERATURE,
                               alpha=ALPHA, loss_type=loss_type)
    assert abs(float(got[f"{loss_type}_loss"]) - float(ref)) <= (
        LOSS_RTOL * abs(float(ref)))


def _port_model(over):
    cfg = MelHuBERTConfig.from_dict(dict(BASE, **over))
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(0), _jax_cfg(dict(BASE, **over))))
    return load_model(params, cfg), cfg


@pytest.mark.parametrize("what", ["causal", "deep pos-conv", "halo"])
def test_seqpar_refuses_what_jax_refuses(what):
    """Causal attention, pos_conv_depth > 1 and a shard shorter than the
    pos-conv halo raise NotImplementedError, as in JAX
    (tests/test_seqpar.py:126-145); JAX refuses the same inputs."""
    t = 128
    over = {"causal": {"attention_type": "causal"},
            "deep pos-conv": {},
            "halo": {"conv_pos": 512, "conv_pos_groups": 4}}[what]
    model, cfg = _port_model(over)
    if what == "deep pos-conv":
        import dataclasses
        model.cfg = dataclasses.replace(cfg, pos_conv_depth=2)
    feat = torch.zeros((1, t, BASE["feat_emb_dim"]))
    pad = torch.ones((1, t))
    match = {"causal": "non-causal", "deep pos-conv": "pos_conv_depth",
             "halo": "halo"}[what]
    with pytest.raises(NotImplementedError, match=match):
        tseqpar.melhubert_extract_seqpar(model, feat, pad)
    jcfg = _jax_cfg(dict(BASE, **over, **(
        {"pos_conv_depth": 2} if what == "deep pos-conv" else {})))
    with pytest.raises(NotImplementedError, match=match):
        melhubert_extract_seqpar(
            jax.tree.map(np.asarray, init_melhubert_params(
                jax.random.PRNGKey(0), _jax_cfg(dict(BASE, **over)))),
            jcfg, jnp.asarray(feat.numpy()), jnp.asarray(pad.numpy()),
            make_mesh(8), attn_impl="dense")
