"""Whether two copies of a CUDA source compile to the same machine code:
each kernel's SASS (``cuobjdump -sass``) in this checkout's library and in
the library of another copy, compared instruction by instruction.

    mkdir -p chip_proof/parent && git archive HEAD~1 openobj_torch/csrc | tar -x -C chip_proof/parent
    python -m openobj_torch.scripts.sass_diff fused_field \\
        chip_proof/parent/openobj_torch/csrc/fused_field.cu

It builds both with the same ``nvcc`` flags (``openobj_torch.kernels``),
lists each library's kernels with their instructions, and prints every
kernel whose instructions differ or that only one library has, then how
many are identical. Addresses and encodings are left out, and so is the
anonymous namespace's hash in mangled names: it follows the source's path,
so the same code at another path would otherwise share no kernel name.
Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from openobj_torch import kernels

_NS = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
_INSN = re.compile(r"/\*[0-9a-f]{4,6}\*/\s+([^;]*;)")


def functions(sass: str) -> dict[str, list[str]]:
    """{kernel: its instructions} of ``cuobjdump -sass`` output, with the
    namespace hash replaced by ``NS_`` and whitespace collapsed."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _NS.sub("NS_", part.split("\n", 1)[0].strip())
        out[name] = [_NS.sub("NS_", re.sub(r"\s+", " ", m.group(1))).strip()
                     for m in _INSN.finditer(part)]
    return out


def compare(a: dict, b: dict) -> tuple[int, list[str]]:
    """(kernels identical in both, the names of the others)."""
    names = sorted(set(a) | set(b))
    differ = [n for n in names if a.get(n) != b.get(n)]
    return len(names) - len(differ), differ


def _sass(lib: Path) -> str:
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", help="a source of openobj_torch/csrc, e.g. fused_field")
    ap.add_argument("other", type=Path, help="another copy of that source")
    args = ap.parse_args(argv)
    srcs = [args.name, args.other.resolve()]
    kernels.build(srcs)
    this, other = (functions(_sass(kernels.lib_path(s))) for s in srcs)
    same, differ = compare(this, other)
    for n in differ:
        print(f"[sass] differs: {n[:100]} ({len(this.get(n, []))} / "
              f"{len(other.get(n, []))} instructions)", flush=True)
    print(f"[sass] {same} of {same + len(differ)} kernels identical", flush=True)
    print(json.dumps({"identical": same, "differ": differ}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
