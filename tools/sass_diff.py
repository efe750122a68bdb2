#!/usr/bin/env python3
"""Compare the machine code (SASS) of the PyTorch port's CUDA kernels in two
trees, kernel by kernel, to show that an edit left some kernels' code as it
was (a shared header, a new template parameter).

    python3 tools/sass_diff.py OLD_ROOT [NEW_ROOT]   # NEW_ROOT: this tree

Builds each tree's kernel library with that tree's own
``speech_ssl_compression_tpu_torch.ops._kernels.build`` (one subprocess per
tree, so the two trees' modules never mix), disassembles it with
``cuobjdump -sass``, strips the instruction addresses and the hash that
names an anonymous namespace, and prints one line per kernel: its
instruction count in each tree and "same", "DIFFERENT", "only old" or
"only new". Needs nvcc and cuobjdump; imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from speech_ssl_compression_tpu_torch.ops import _kernels; "
         "print(_kernels.build()); print(_kernels._cuda_tool('cuobjdump'))")
# an anonymous namespace's name carries hashes of its file
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")


def kernels(root: pathlib.Path) -> dict:
    """{kernel symbol, hashes stripped: [instruction lines]}"""
    lib, cuobjdump = subprocess.run(
        [sys.executable, "-c", BUILD, str(root)], capture_output=True,
        text=True, check=True).stdout.split()[-2:]
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = ANON.sub(r"_GLOBAL__N__\1",
                            line.split("Function :", 1)[1].strip())
            out[name] = []
        elif name is not None and "*/" in line:
            out[name].append(re.sub(r"^\s*/\*[0-9a-f]+\*/", "", line).strip())
    return out


def main() -> None:
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    old = kernels(pathlib.Path(sys.argv[1]).resolve())
    new = kernels(pathlib.Path(sys.argv[2] if len(sys.argv) == 3
                               else HERE).resolve())
    for name in sorted(set(old) | set(new)):
        if name not in new:
            verdict = "only old"
        elif name not in old:
            verdict = "only new"
        else:
            verdict = "same" if old[name] == new[name] else "DIFFERENT"
        print(f"{verdict:9} {len(old.get(name, [])):6} "
              f"{len(new.get(name, [])):6}  {name}", flush=True)


if __name__ == "__main__":
    main()
