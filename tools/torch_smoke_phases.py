"""Build the kernels and run chip_smoke.py's preprocess, train, fairseq
dump, device masks, deep pos-conv and wave_bench phases alone, on one
card, with their launch counts and each phase's seconds; with
``--journey``, the journey phase alone; with ``--grouped-conv``, the
grouped conv phase alone (it needs no kernel built). Run from the
repository's root:

    python3 tools/torch_smoke_phases.py [--journey | --grouped-conv]
"""
import json
import pathlib
import sys
import tempfile
import time
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import torch
import chip_smoke as cs
from speech_ssl_compression_tpu_torch.ops import _kernels

dev = torch.device("cuda", 0)
gpu = cs.gpu_name_and_power()
print("gpu:", gpu, flush=True)
if "--grouped-conv" in sys.argv[1:]:
    cs.timed("grouped conv", cs.phase_grouped_conv, dev, gpu)
    sys.exit(0)
t0 = time.perf_counter()
_kernels.build()
_kernels.load()
print("build", time.perf_counter() - t0, flush=True)
if "--journey" in sys.argv[1:]:
    with tempfile.TemporaryDirectory() as tmp:
        paths = cs.timed("journey", cs.phase_journey, dev, gpu, tmp)
    print(json.dumps(paths))
    print({k: round(v, 1) for k, v in cs.PHASE_SECONDS.items()})
    sys.exit(0)
with tempfile.TemporaryDirectory() as tmp:
    csv = cs.timed("preprocess", cs.phase_preprocess, dev, gpu, tmp)
    with cs.unread_saves_skipped("train", lambda p: not p.endswith(
            "states-epoch-0.npz")):
        runner, batch, train, snap = cs.timed("train", cs.phase_train, dev,
                                              gpu, tmp, csv)
    f = cs.timed("fairseq dump", cs.phase_fairseq_dump, dev, gpu, tmp, runner)
    m = cs.timed("device masks", cs.phase_device_masks, dev, gpu, runner,
                 batch)
    ds, dt = cs.timed("deep pos-conv", cs.phase_deep_pos_conv, dev, gpu, tmp,
                      batch)
    del runner, batch, snap
    wb = cs.timed("wave_bench", cs.phase_wave_bench, dev, gpu)
print(json.dumps({"fairseq": f, "masks": m, "deep_serve": ds,
                  "deep_train": dt, **wb}))
print({k: round(v, 1) for k, v in cs.PHASE_SECONDS.items()})
