"""Offline preprocessing CLI: a Kaldi LibriSpeech release -> .npy features,
cluster labels and the training CSVs.

Port of the root ``preprocess.py`` (reference preprocess.sh and
preprocess/tidy_libri{360,960}_kaldi_data.py), on the port's
``data/preprocess.py::tidy_kaldi_data``:

    python -m speech_ssl_compression_tpu_torch.preprocess <kaldi_dir> \\
        <out_dir> [--hours 360|960] [--tar PATH] [--num-cluster N]

``--tar`` unpacks the release into ``kaldi_dir`` first and flattens the
960 h release's nested ``stage2-cluster-20ms/split200`` (reference
preprocess.sh:7-8), as the root script does. Numpy only: nothing here
touches a device.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess

from .data.preprocess import tidy_kaldi_data

# the two release layouts: {hours: tidy_kaldi_data's arguments}
LAYOUTS = {
    # reference tidy_libri960_kaldi_data.py:31-35
    960: dict(feat_scp="fbank/train-960.scp",
              mean_var="fbank/train-960.mean-var",
              cluster_dirs={"10ms": "stage2-cluster-10ms",
                            "20ms": "stage2-cluster-20ms"},
              label_scp_name="train_960.hubert8.bas.scp",
              csv_prefix="libri960-stg2"),
    # everything at the data dir's root under train-clean-360.* names
    # (reference tidy_libri360_kaldi_data.py:29-37)
    360: dict(feat_scp="train-clean-360.scp",
              mean_var="train-clean-360.mean-var",
              cluster_dirs={"20ms": "."},
              label_scp_name="train-clean-360-k512-e10.bas.scp",
              csv_prefix="libri-360-data-cluster-pair"),
}


def unpack_release(tar: str, data_dir: str) -> None:
    """``tar -xf`` into ``data_dir``, then move the 20 ms cluster split's
    files up out of ``split200/``: without it the 20 ms label scp is
    missing and that frame period's labels and CSV are never written."""
    pathlib.Path(data_dir).mkdir(parents=True, exist_ok=True)
    subprocess.run(["tar", "-xf", tar, "-C", data_dir], check=True)
    split = pathlib.Path(data_dir) / "stage2-cluster-20ms" / "split200"
    if split.is_dir():
        for item in split.iterdir():
            item.rename(split.parent / item.name)
        split.rmdir()


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("data_dir")
    p.add_argument("out_dir")
    p.add_argument("--hours", type=int, choices=sorted(LAYOUTS), default=960)
    p.add_argument("--tar", default=None,
                   help="release tarball to unpack into data_dir first")
    p.add_argument("--num-cluster", type=int, default=512)
    args = p.parse_args(argv)
    if args.tar:
        unpack_release(args.tar, args.data_dir)
    tidy_kaldi_data(args.data_dir, args.out_dir,
                    num_cluster=args.num_cluster, **LAYOUTS[args.hours])
    print(f"[Preprocess] wrote features/labels/CSVs to {args.out_dir}")
    return args.out_dir


if __name__ == "__main__":
    main()
