#!/usr/bin/env python3
"""Compare one kernel's machine code (SASS) between two kernel source trees.

    python3 tools/sass_diff.py DIR_A DIR_B SOURCE REGEX

Compiles SOURCE (a file name under each DIR, e.g. ``flash_attention.cu``)
of DIR_A and of DIR_B (two ``csrc`` directories: this checkout's and
another commit's, unpacked with ``git archive``) with the flags
``repro_torch.kernels._build`` uses, both at once, dumps each object with
``cuobjdump -sass`` and takes the functions whose mangled name matches
REGEX (one regex for both trees: a template parameter that became an
``int`` from a ``bool`` mangles as ``Li0E`` where it was ``Lb0E``, so
write ``L[ib]0E``). For each function it prints ptxas's registers and
spills, the count of instructions, and whether the two trees' instructions
are the same once addresses and encodings are stripped; where they are
not, the start of a unified diff. Needs ``nvcc`` and ``cuobjdump``.
"""
from __future__ import annotations

import difflib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels._build import NVCC_FLAGS, find_nvcc  # noqa: E402


def compile_all(nvcc: str, dirs, source: str, out: Path) -> list:
    """Each DIR's SOURCE into its own object; returns (object, ptxas log)."""
    objs = [out / f"{i}.o" for i in range(len(dirs))]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(d), "-c", str(d / source), "-o",
         str(o)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for d, o in zip(dirs, objs)]
    logs = [p.communicate()[0] for p in procs]
    for d, p, log in zip(dirs, procs, logs):
        if p.returncode:
            raise SystemExit(f"nvcc failed on {d / source}:\n{log[-3000:]}")
    return list(zip(objs, logs))


def functions(cuobjdump: str, obj: Path, pattern: str) -> dict:
    """Mangled name -> instructions (addresses and encodings stripped)."""
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
        if name and ins:
            out[name].append(ins.group(1))
    return out


def ptxas_line(log: str, name: str) -> str:
    """ptxas's 'Used ... registers' and spill lines of one entry."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if f"'{name}'" in ln and "Compiling entry function" in ln:
            tail = [t.split("info    :")[-1].strip()
                    for t in lines[i + 1:i + 4]
                    if "Used" in t or "spill" in t]
            return "; ".join(tail)
    return "not reported"


def main() -> None:
    if len(sys.argv) != 5:
        raise SystemExit(__doc__)
    dirs = [Path(d).resolve() for d in sys.argv[1:3]]
    source, pattern = sys.argv[3], sys.argv[4]
    nvcc = find_nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(nvcc).parent / "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        built = compile_all(nvcc, dirs, source, Path(tmp))
        funcs = [functions(cuobjdump, obj, pattern) for obj, _ in built]
    for d, (_, log), fs in zip(dirs, built, funcs):
        print(f"{d}: {len(fs)} function(s) match")
        for name, ins in fs.items():
            print(f"  {name}: {len(ins)} instructions; "
                  f"{ptxas_line(log, name)}")
    a = [ins for _, ins in sorted(funcs[0].items())]
    b = [ins for _, ins in sorted(funcs[1].items())]
    if not a or len(a) != len(b):
        raise SystemExit("the trees match different numbers of functions")
    for ia, ib in zip(a, b):
        print("identical" if ia == ib else "different")
        if ia != ib:
            print("\n".join(list(difflib.unified_diff(
                ia, ib, "a", "b", lineterm="", n=2))[:80]))


if __name__ == "__main__":
    main()
