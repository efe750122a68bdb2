"""The port's offline data path against the JAX package: Kaldi ark/scp I/O
(``data/kaldi_io.py``: parsed matrices and written bytes bitwise JAX's,
on ``tests/golden/kaldi_ark.npz`` and beyond), ``tidy_kaldi_data`` (the
same files: bitwise arrays, the same CSV text), the preprocess CLI
against the root ``preprocess.py`` (``--hours 360``, ``--hours 960``,
``--tar`` with the nested split200), ``FairseqDumpBuckets`` (bitwise
batches at 10 and 20 ms, multitask on and off), ``TextCompressor``
(JAX's bytes at each level) and the last small helpers
(``LabelEncoder``, ``pack_rows_needed``, ``read_ogg``/``write_ogg``,
``is_sf_audio_data``). Releases are written by ``chip_smoke.py``'s
``write_kaldi_release``, the writer its preprocess phase uses."""

import importlib.util
import io
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

from speech_ssl_compression_tpu.data import kaldi_io as jkaldi
from speech_ssl_compression_tpu.data import audio as jaudio
from speech_ssl_compression_tpu.data.dictionary import (
    Dictionary as JaxDictionary,
    LabelEncoder as JaxLabelEncoder,
)
from speech_ssl_compression_tpu.data.fairseq_dump import (
    FairseqDumpBuckets as JaxDump,
    get_feat_iterator as jax_feat_iterator,
)
from speech_ssl_compression_tpu.data.preprocess import (
    tidy_kaldi_data as jax_tidy,
)
from speech_ssl_compression_tpu.data.text_compressor import (
    TextCompressionLevel as JaxLevel,
    TextCompressor as JaxCompressor,
)
from speech_ssl_compression_tpu.ops import packing as jpacking
from speech_ssl_compression_tpu_torch import preprocess as port_cli
from speech_ssl_compression_tpu_torch.data import audio as taudio
from speech_ssl_compression_tpu_torch.data import kaldi_io as tkaldi
from speech_ssl_compression_tpu_torch.data.dictionary import (
    Dictionary,
    LabelEncoder,
)
from speech_ssl_compression_tpu_torch.data.fairseq_dump import (
    FairseqDumpBuckets,
    get_feat_iterator,
)
from speech_ssl_compression_tpu_torch.data.preprocess import tidy_kaldi_data
from speech_ssl_compression_tpu_torch.data.text_compressor import (
    TextCompressionLevel,
    TextCompressor,
)
from speech_ssl_compression_tpu_torch.ops import packing

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

GOLDEN = REPO / "tests" / "golden" / "kaldi_ark.npz"


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------- Kaldi I/O

@pytest.mark.parametrize("key", ["fm_bytes", "cm_bytes"])
def test_golden_arks_parse_to_jax_bits(key):
    raw = np.load(GOLDEN)[key].tobytes()
    got = tkaldi.parse_feat_matrix(io.BytesIO(raw))
    ref = jkaldi.parse_feat_matrix(io.BytesIO(raw))
    assert got.dtype == np.float64  # FM too, as JAX's (kaldi_io.py:49)
    assert _same(got, ref)


def _cm2_bytes(mat):
    mn, rg = float(mat.min()), float(mat.max() - mat.min())
    codes = np.clip(np.round((mat - mn) / rg * 65535), 0, 65535)
    return (b"\x00BCM2 " + struct.pack("<ffii", mn, rg, *mat.shape)
            + codes.astype("<u2").tobytes())


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("source", ["golden", "random", "one_row"])
def test_written_bytes_are_jax_and_parse_back(compress, source):
    rng = np.random.default_rng(4)
    mat = {"golden": np.load(GOLDEN)["mat"],
           "random": rng.standard_normal((53, 13)) * 3 - 1,
           "one_row": rng.standard_normal((1, 6))}[source]
    got, ref = io.BytesIO(), io.BytesIO()
    tkaldi.write_feat_matrix(got, mat, compress=compress)
    jkaldi.write_feat_matrix(ref, mat, compress=compress)
    assert got.getvalue() == ref.getvalue()
    got.seek(0)
    ref.seek(0)
    assert _same(tkaldi.parse_feat_matrix(got),
                 jkaldi.parse_feat_matrix(ref))
    # CM2 and DM payloads
    cm2 = _cm2_bytes(mat)
    assert _same(tkaldi.parse_feat_matrix(io.BytesIO(cm2)),
                 jkaldi.parse_feat_matrix(io.BytesIO(cm2)))
    dm = (b"\x00BDM " + b"\x04" + struct.pack("<i", mat.shape[0]) + b"\x04"
          + struct.pack("<i", mat.shape[1]) + mat.astype("<f8").tobytes())
    assert _same(tkaldi.parse_feat_matrix(io.BytesIO(dm)), mat)


def test_bad_tokens_raise_as_in_jax():
    for raw in (b"\x00BXM ", b"\x01BFM ", b"\x00BFM \x08"):
        for mod in (tkaldi, jkaldi):
            with pytest.raises(ValueError):
                mod.parse_feat_matrix(io.BytesIO(raw))


def test_scp_mean_var_and_label_readers_are_jax(tmp_path):
    utts = chip_smoke.synthetic_utterances(3, seed=5)
    keys = chip_smoke.write_kaldi_release(tmp_path, utts, n_cm=1)
    scp = tmp_path / "fbank" / "train-960.scp"
    for data_dir in (None, str(tmp_path / "elsewhere")):
        assert tkaldi.read_scp(str(scp), data_dir) == jkaldi.read_scp(
            str(scp), data_dir)
    index = tkaldi.read_scp(str(scp))
    assert list(index) == keys
    mv = str(tmp_path / "fbank" / "train-960.mean-var")
    for a, b in zip(tkaldi.read_mean_var(mv), jkaldi.read_mean_var(mv)):
        assert _same(a, b)
    lab_scp = tmp_path / "stage2-cluster-10ms" / "train_960.hubert8.bas.scp"
    for key, (path, off) in tkaldi.read_scp(str(lab_scp)).items():
        got = tkaldi.read_text_labels(path, off)
        assert _same(got, jkaldi.read_text_labels(path, off))
        assert np.array_equal(got, utts[keys.index(key)][1])


# ------------------------------------------------------ tidy_kaldi_data

def _tree_files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _same_outputs(got: pathlib.Path, ref: pathlib.Path):
    """Every file of the two output trees: .npy bitwise (dtype included),
    CSVs as text with each tree's own root in its paths."""
    assert _tree_files(got) == _tree_files(ref)
    for name in _tree_files(got):
        a, b = got / name, ref / name
        if name.endswith(".npy"):
            assert _same(np.load(a), np.load(b)), name
        else:
            assert a.read_text().replace(str(got), "<out>") == (
                b.read_text().replace(str(ref), "<out>")), name


def test_tidy_kaldi_data_writes_jax_files(tmp_path, capsys):
    utts = chip_smoke.synthetic_utterances(6, seed=2)
    release = tmp_path / "release"
    chip_smoke.write_kaldi_release(release, utts, n_cm=2)
    jax_tidy(str(release), str(tmp_path / "jax"))
    ref_out = capsys.readouterr().out
    tidy_kaldi_data(str(release), str(tmp_path / "port"))
    got_out = capsys.readouterr().out
    # the 20 ms labels are nested under split200/: both warn and skip them
    assert "WARNING" in got_out and got_out.replace(
        "port", "X") == ref_out.replace("jax", "X")
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert not (tmp_path / "port" / "libri960-stg2-20ms.csv").exists()
    feats = np.load(tmp_path / "port" / "feature" / "utt000.npy")
    assert feats.dtype == np.float64
    # the range assert on labels is kept
    bad = tmp_path / "bad"
    chip_smoke.write_kaldi_release(bad, [(utts[0][0], utts[0][1] + 600)])
    with pytest.raises(AssertionError, match="out of range"):
        tidy_kaldi_data(str(bad), str(tmp_path / "bad_out"))


def _root_cli():
    spec = importlib.util.spec_from_file_location("root_preprocess",
                                                  REPO / "preprocess.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _release(root, hours, tar=False):
    utts = chip_smoke.synthetic_utterances(5, seed=hours)
    staging = root / "staging"
    chip_smoke.write_kaldi_release(staging, utts, hours=hours, n_cm=1)
    if not tar:
        return str(staging), []
    path = root / "release.tar"
    subprocess.run(["tar", "-cf", str(path), "-C", str(staging), "."],
                   check=True)
    return str(root / "data"), ["--tar", str(path)]


@pytest.mark.parametrize("hours,tar", [(360, False), (960, False),
                                       (960, True)])
def test_cli_writes_what_the_root_cli_writes(tmp_path, monkeypatch, capsys,
                                             hours, tar):
    root = _root_cli()
    args = ["--hours", str(hours), "--num-cluster", "512"]
    runs = {}
    for name in ("jax", "port"):
        data_dir, extra = _release(tmp_path / name, hours, tar)
        argv = [data_dir, str(tmp_path / name / "out")] + args + extra
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["preprocess.py"] + argv)
            root.main()
        else:
            assert port_cli.main(argv) == argv[1]
        runs[name] = pathlib.Path(data_dir)
    capsys.readouterr()
    _same_outputs(tmp_path / "port" / "out", tmp_path / "jax" / "out")
    csvs = sorted(p.name for p in (tmp_path / "port" / "out").glob("*.csv"))
    assert csvs == {360: ["libri-360-data-cluster-pair-20ms.csv"],
                    960: ["libri960-stg2-10ms.csv"] + (
                        ["libri960-stg2-20ms.csv"] if tar else [])}[hours]
    if tar:  # split200 flattened, as the root script does
        assert _tree_files(runs["port"]) == _tree_files(runs["jax"])
        assert not (runs["port"] / "stage2-cluster-20ms" / "split200").exists()


def test_cli_runs_as_a_module(tmp_path):
    data_dir, extra = _release(tmp_path, 960, tar=True)
    out = tmp_path / "out"
    subprocess.run([sys.executable, "-m",
                    "speech_ssl_compression_tpu_torch.preprocess", data_dir,
                    str(out)] + extra, check=True, cwd=str(REPO),
                   capture_output=True)
    assert (out / "libri960-stg2-20ms.csv").read_text().count("\n") == 6


# ------------------------------------------------------- the fairseq dump

def _dump(root, lengths=(40, 31, 26, 20, 17, 9), dim=8):
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((n, dim)).astype(np.float32)
             for n in lengths]
    np.save(root / "train.npy", np.concatenate(feats))
    (root / "train.len").write_text("".join(f"{n}\n" for n in lengths))
    labels = [" ".join(map(str, rng.integers(0, 5, n))) for n in lengths]
    (root / "train.km").write_text("\n".join(labels) + "\n")
    np.save(root / "ms.npy", np.stack([rng.standard_normal(dim),
                                       rng.uniform(0.5, 2, dim)]))
    for rank in range(2):
        part = feats[rank::2]
        np.save(root / f"train_{rank}_2.npy", np.concatenate(part))
        (root / f"train_{rank}_2.len").write_text(
            "".join(f"{len(f)}\n" for f in part))


@pytest.mark.parametrize("multitask", [False, True])
@pytest.mark.parametrize("fp", [10, 20])
def test_fairseq_dump_batches_are_jax(tmp_path, fp, multitask):
    _dump(tmp_path)
    kw = dict(frame_period=fp, sequence_length=12, bucket_size=4,
              feat_dir=str(tmp_path), label_dir=str(tmp_path), split="train",
              mean_std_pth=str(tmp_path / "ms.npy"), multitask=multitask,
              pad_multiple=8, seed=3)
    got, ref = FairseqDumpBuckets(**kw), JaxDump(**kw)
    assert len(got) == len(ref) == 2
    for _ in range(2):  # two epochs: the shuffles and crops continue
        batches = list(zip(got.epoch(), ref.epoch()))
        assert len(batches) == 2
        for a, b in batches:
            assert a.keys() == b.keys()
            assert ("label2" in a) == multitask
            for k in a:
                assert _same(a[k], b[k]), k


def test_fairseq_dump_drops_a_trailing_single_utterance(tmp_path):
    _dump(tmp_path, lengths=(12, 10, 8))
    kw = dict(frame_period=20, sequence_length=0, bucket_size=2,
              feat_dir=str(tmp_path), label_dir=str(tmp_path), split="train",
              mean_std_pth=str(tmp_path / "ms.npy"))
    got, ref = FairseqDumpBuckets(**kw), JaxDump(**kw)
    assert len(got) == len(ref) == 1
    for k, v in got.get_batch(0).items():
        assert _same(v, ref.get_batch(0)[k])


def test_feat_iterator_is_jax(tmp_path):
    _dump(tmp_path)
    for rank in range(2):
        it, n = get_feat_iterator(str(tmp_path), "train", 2, rank)
        jit, jn = jax_feat_iterator(str(tmp_path), "train", 2, rank)
        assert n == jn
        for a, b in zip(it(), jit()):
            assert _same(a, b)


# ------------------------------------------------------------ the helpers

@pytest.mark.parametrize("level", ["none", "low", "high"])
def test_text_compressor_bytes_are_jax(level):
    text = "train-clean-100/19/198/19-198-0001.flac\t215680\n" * 40 + "é ü"
    got = TextCompressor(TextCompressionLevel[level])
    ref = JaxCompressor(JaxLevel[level], max_input_byte_length=1024)
    packed = got.compress(text)
    assert packed == ref.compress(text)
    assert got.decompress(packed) == text == ref.decompress(packed)


def test_label_encoder_is_jax(tmp_path):
    path = tmp_path / "dict.km.txt"
    path.write_text("".join(f"{s} 1\n" for s in ("7", "3", "-1", "0", "5")))
    got = LabelEncoder(Dictionary.load(str(path)))
    ref = JaxLabelEncoder(JaxDictionary.load(str(path)))
    for line in ("7 3 0 5", "5 5 -1 9 x", ""):
        assert _same(got(line), ref(line))


def test_pack_rows_needed_is_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        lengths = list(rng.integers(1, 300, rng.integers(1, 30)))
        cap = int(rng.integers(300, 900))
        assert packing.pack_rows_needed(lengths, cap) == (
            jpacking.pack_rows_needed(lengths, cap))


def test_ogg_helpers_are_jax(tmp_path):
    t = np.arange(16000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    stereo = np.stack([wav, 0.5 * wav])
    for name, x in (("mono", wav), ("stereo", stereo)):
        got, ref = tmp_path / f"{name}.ogg", tmp_path / f"{name}_jax.ogg"
        taudio.write_ogg(str(got), x, 16000, quality=0.5)
        jaudio.write_ogg(str(ref), x, 16000, quality=0.5)
        assert got.read_bytes() == ref.read_bytes()
        (a, sr), (b, jsr) = taudio.read_ogg(str(got)), jaudio.read_ogg(
            str(ref))
        assert sr == jsr == 16000 and _same(a, b)
        assert a.shape[0] == (1 if x.ndim == 1 else 2)
    for data in (b"OggS\x00", b"RIFF....", b"fLaC", b"ID3", b"Og", b""):
        assert taudio.is_sf_audio_data(data) == jaudio.is_sf_audio_data(data)
