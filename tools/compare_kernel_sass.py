#!/usr/bin/env python3
"""Whether two source trees of qtpu_torch compile their CUDA kernels to the
same machine code.

    python3 tools/compare_kernel_sass.py PARENT .

Builds every source of each TREE's `qtpu_torch/csrc` with that tree's own
build (`qtpu_torch.kernels._build.build`, in a process of its own), dumps
each library's SASS with `cuobjdump -sass`, and compares it function by
function. Prints one JSON line per source: the kernels only the first tree
has, only the second has, those in both with the same SASS and those that
differ, and the pairs of a kernel only the first tree has and one only the
second has whose SASS is the same ("renamed_same": an instance whose name
gained a template argument, with the code it had). Two kernels with the
same SASS run the same instructions, so their times may differ only by the
card's noise. Needs nvcc and cuobjdump (the
CUDA toolkit); it imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

BUILD = ("import json, sys; sys.path.insert(0, '.'); "
         "from qtpu_torch.kernels import _build; "
         "_build.build(); print(json.dumps({n: str(_build._lib_path(n)) for n in _build.SOURCES}))")


def libraries(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def cuobjdump() -> str:
    from shutil import which

    for cand in ("/usr/local/cuda/bin/cuobjdump", which("cuobjdump")):
        if cand and Path(cand).is_file():
            return cand
    raise SystemExit("cuobjdump not found")


def functions(lib: str) -> dict:
    """{mangled kernel name: its SASS with addresses and comments removed}."""
    sass = subprocess.run([cuobjdump(), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    funcs, name, body = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = "\n".join(body)
            # an anonymous namespace's mangled name carries hashes of its file's path
            name, body = re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}", r"\1\2",
                                m.group(1)), []
            continue
        if name is None:
            continue
        code = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip()
        if code:
            body.append(code)
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs=2, type=Path)
    a, b = (libraries(t.resolve()) for t in ap.parse_args().trees)
    for src in sorted(set(a) | set(b)):
        fa = functions(a[src]) if src in a else {}
        fb = functions(b[src]) if src in b else {}
        both = sorted(set(fa) & set(fb))
        only_a, only_b = sorted(set(fa) - set(fb)), sorted(set(fb) - set(fa))
        print(json.dumps({
            "source": src, "only_first": only_a, "only_second": only_b,
            "same": [f for f in both if fa[f] == fb[f]],
            "different": [f for f in both if fa[f] != fb[f]],
            "renamed_same": [[f, g] for f in only_a for g in only_b if fa[f] == fb[g]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
