"""Bisect a build failure of K1 by cutting its decode short: the port of
``tools/pa_bisect.py``.

    python -m libmspack_tpu_torch.tools.cut_bisect <marker>

Copies ``csrc/deflate_core.cuh`` (with the sources it builds with) into a
temporary directory and inserts, after the first line that contains
``marker``, a statement that ends the function being decoded there: the
JAX tool inserted ``RET``, which returns the step's state; here it is
``return;`` in a ``void`` function and ``return {};`` (a zeroed
``Result``, ``ERR_OK``, ``false``) in any other. Then it compiles
``inflate.cu`` against the cut copy, compile only, as the JAX tool only
lowered and compiled: ``nvcc -c`` for ``sm_90a`` where nvcc is there,
else the g++ twin's build (``DEFLATE_CORE_HOST_TWIN``). Prints
``CUT[<marker>]: compile OK`` with ptxas's registers and spill bytes (or
which compiler ran), or ``CUT[<marker>]: FAIL`` with the first error
line. It never writes into ``csrc/`` or ``_build/``; a marker that is not
in the file is an error, as in the JAX tool.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

from .. import kernels

CORE = "deflate_core.cuh"
SOURCES = ("inflate.cu", "deflate_core.cuh", "stream_core.cuh",
           "launch_info.cuh")
# a function of the core: its return type, then its name and "("
_FN = re.compile(r"^\s*(?:DC_FN|SC_FN|SC_MEMBER|DC_NOINLINE)\s+"
                 r"(?:DC_NOINLINE\s+)?([\w:<>]+)\s+\w+\s*\(")


def cut_source(text: str, marker: str) -> str:
    """``text`` with the cut statement after the first line containing
    ``marker``; raises ``ValueError`` where there is none."""
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if marker in line:
            ret = "void"
            for prev in reversed(lines[:i + 1]):
                m = _FN.match(prev)
                if m:
                    ret = m.group(1)
                    break
            stmt = "return;" if ret == "void" else "return {};"
            indent = re.match(r"\s*", line).group(0)
            lines.insert(i + 1, f"{indent}{stmt}  // CUT[{marker}]\n")
            return "".join(lines)
    raise ValueError(f"marker {marker!r} not found in {CORE}")


def _compiler() -> tuple[list[str], str]:
    """The compile-only command for the cut copy (run in its directory)
    and what it is."""
    try:
        nvcc = kernels.nvcc_path()
    except RuntimeError:
        nvcc = None
    if nvcc:
        return ([nvcc] + kernels.NVCC_FLAGS + ["-c", "inflate.cu", "-o",
                                               "inflate.o"], "nvcc sm_90a")
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("neither nvcc nor g++ is here")
    return ([gxx, "-O2", "-std=c++17", "-fsyntax-only",
             "-DDEFLATE_CORE_HOST_TWIN", "-x", "c++", CORE],
            "g++ twin (no ptxas)")


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes of each kernel in a ptxas log."""
    rep = kernels.ptxas_report(log)
    return "; ".join(f"{k}: {v}" for k, v in sorted(rep.items())) or \
        "(no ptxas lines)"


def cut(marker: str) -> tuple[bool, str]:
    """Compile the cut copy; ``(ok, the line to print)``."""
    with open(os.path.join(kernels.CSRC, CORE)) as fh:
        text = cut_source(fh.read(), marker)
    with tempfile.TemporaryDirectory() as work:
        for name in SOURCES:
            shutil.copy(os.path.join(kernels.CSRC, name), work)
        with open(os.path.join(work, CORE), "w") as fh:
            fh.write(text)
        cmd, what = _compiler()
        r = subprocess.run(cmd, cwd=work, capture_output=True, text=True)
    if r.returncode == 0:
        detail = ptxas_summary(r.stderr) if what.startswith("nvcc") else ""
        return True, f"CUT[{marker}]: compile OK ({what}) {detail}".rstrip()
    first = next((ln for ln in r.stderr.splitlines() if "error" in ln),
                 r.stderr.strip().splitlines()[0] if r.stderr.strip()
                 else f"exit {r.returncode}")
    return False, f"CUT[{marker}]: FAIL ({what}) {first[:200]}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m libmspack_tpu_torch.tools.cut_bisect "
              "<marker>", file=sys.stderr)
        return 2
    try:
        ok, line = cut(argv[0])
    except ValueError as e:
        print(f"cut_bisect: {e}", file=sys.stderr)
        return 2
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
