#!/usr/bin/env python3
"""Compare the machine code (SASS) of this checkout's CUDA kernels with
another checkout's, kernel by kernel.

    python3 sass_compare.py OTHER_ROOT

Compiles every `gvfdiffusion_torch/csrc/*.cu` of both trees with the
build's flags (`_ext.py`: sm_90a, -O3) to a cubin, disassembles each with
`cuobjdump -sass`, and prints, for every kernel, whether its instructions
are the same in both trees, differ, or exist in one tree only (instruction
addresses and encodings dropped, anonymous-namespace names made
comparable). Needs the CUDA toolkit (nvcc, cuobjdump); no card. Used to
show that a change to a shared header leaves the other kernels' code as it
was.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
# an anonymous namespace's name carries hashes of the file
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}")


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", name)


def cubins(root: Path, out: Path) -> list:
    """One cubin per source of root's csrc/, compiled at once."""
    srcs = sorted((root / "gvfdiffusion_torch" / "csrc").glob("*.cu"))
    procs = [(s, subprocess.Popen(
        [_tool("nvcc"), *FLAGS, "-cubin", "-o", str(out / f"{s.stem}.cubin"),
         str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for s in srcs]
    for s, p in procs:
        msg = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {s} failed:\n{msg}")
    return [out / f"{s.stem}.cubin" for s in srcs]


def kernels(cubin: Path) -> dict:
    """{kernel name: its SASS instructions} of one cubin; branch labels
    renumbered by their first use in the kernel (the file numbers them)."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    out, name, labels = {}, None, {}

    def label(m):
        return labels.setdefault(m.group(0), f".L{len(labels)}")

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, labels = _ANON.sub(r"_GLOBAL__N__\1", m.group(1)), {}
            out[name] = []
        elif name and "/*" in line and ";" in line:
            instr = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0])
            instr = re.sub(r"\.L_x_\d+", label, instr)
            out[name].append(_ANON.sub(r"_GLOBAL__N__\1", instr.strip()))
    return out


def sass_of(root: Path) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        found = {}
        for c in cubins(root, Path(tmp)):
            for name, code in kernels(c).items():
                found[f"{c.stem}:{name}"] = code
        return found


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    mine, other = sass_of(HERE), sass_of(Path(argv[0]).resolve())
    same = sorted(k for k in mine if k in other and mine[k] == other[k])
    differ = sorted(k for k in mine if k in other and mine[k] != other[k])
    new = sorted(set(mine) - set(other))
    gone = sorted(set(other) - set(mine))
    # a kernel whose name changed (a template argument added) and whose
    # code did not: the same file, the same instructions
    renamed = []
    for g in list(gone):
        match = [n for n in new if n.split(":")[0] == g.split(":")[0]
                 and mine[n] == other[g]]
        if match:
            renamed.append((g, match[0]))
            gone.remove(g)
            new.remove(match[0])
    for k in differ:
        print(f"differs: {k} ({len(other[k])} -> {len(mine[k])} "
              "instructions)")
    for g, n in renamed:
        print(f"renamed, same code: {g} -> {n}")
    for k in new:
        print(f"new: {k} ({len(mine[k])} instructions)")
    for k in gone:
        print(f"gone: {k} ({len(other[k])} instructions)")
    print(json.dumps({"same": len(same), "renamed_same": len(renamed),
                      "differ": len(differ), "new": len(new),
                      "gone": len(gone)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
