"""Compare the visibility kernels' machine code with another tree's, on a
machine with nvcc.

    python -m xr_torch.tools.compare_sass OTHER_ROOT [FUNCTION_SUBSTRING ...]

Compiles ``xr_torch/csrc/vis_stream.cu`` and ``vis_lists.cu`` of this tree
and of OTHER_ROOT (e.g. an earlier commit unpacked with ``git archive``) to
cubins with the flags ``kernels.NVCC_FLAGS`` builds the library with, reads
each with ``cuobjdump -sass`` and compares the SASS function by function.
Prints one JSON line per function whose name holds one of the substrings
(default: the ungated ``fold_kernel`` and ``clear_kernel`` of both walks):
equal, different, or present in one tree only; then ptxas's registers and
spill stores of each fold kernel of this tree. Exits 1 if a compared
function differs or is missing from a tree.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from xr_torch import kernels
from xr_torch.tools.sweep_visibility import fold_kernels

SOURCES = ("vis_stream.cu", "vis_lists.cu")
DEFAULT = ("2xr11fold_kernelI", "2xr12clear_kernelI")


def _sass(root: Path, src: str, out: Path) -> tuple:
    """({function: SASS text}, ptxas log) of one source of one tree."""
    cubin = out / f"{src}.cubin"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    res = subprocess.run([kernels._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", str(cubin),
                          str(root / "xr_torch" / "csrc" / src)],
                         capture_output=True, text=True, check=True)
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}, res.stdout + res.stderr


def main(argv) -> int:
    other = Path(argv[0]).resolve()
    here = Path(kernels.__file__).resolve().parent.parent
    pick = tuple(argv[1:]) or DEFAULT
    bad = 0
    log = ""
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            (Path(tmp) / "a").mkdir(exist_ok=True)
            (Path(tmp) / "b").mkdir(exist_ok=True)
            mine, ptxas = _sass(here, src, Path(tmp) / "a")
            theirs, _ = _sass(other, src, Path(tmp) / "b")
            log += ptxas
            for fn in sorted(set(mine) | set(theirs)):
                if not any(p in fn for p in pick):
                    continue
                if fn in mine and fn in theirs:
                    verdict = "equal" if mine[fn] == theirs[fn] else "different"
                else:
                    verdict = "only here" if fn in mine else "only there"
                bad += verdict != "equal"
                line = {"source": src, "function": fn, "sass": verdict,
                        "instructions": mine.get(fn, "").count(";")}
                if verdict == "different":  # the first lines that differ
                    a, b = mine[fn].splitlines(), theirs[fn].splitlines()
                    line["first_differences"] = [
                        (x.strip(), y.strip()) for x, y in zip(a, b) if x != y][:6]
                    line["lines"] = [len(a), len(b)]
                print(json.dumps(line), flush=True)
    print(json.dumps({"ptxas": fold_kernels(log)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
