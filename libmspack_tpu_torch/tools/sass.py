"""What nvcc made of the kernels: a summary of each kernel's SASS.

A probe times a mechanism only if the compiled kernel still performs it:
a sweep whose result the compiler can predict may be folded into one load
or dropped. K1, K3 and K4 keep their tables in shared memory, and K2 its
work buffer and window, so their per-symbol and per-token loads should be
LDS, not LDG or local LDL. For each kernel of
KERNELS in the library ``kernels.lib()`` builds, this prints its
instruction count, its loads and stores by memory space, its compares and
selects, its warp votes and shuffles, and its backward branches (loops),
and writes the whole listing to a file::

    python -m libmspack_tpu_torch.tools.sass [listing.txt [binary]]

(``binary``: another library or cubin to read instead). It needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from collections import Counter

from .. import kernels

KERNELS = ("k1_inflate_kernel", "k2_pass1_kernel", "k2_pass2_kernel",
           "k3_lzx_kernel", "k4_qtm_kernel",
           "p1_sweep_kernel", "p1_vec_kernel", "p1_reg_kernel",
           "p2_skel_kernel", "p3_copy_kernel", "p3_par_kernel",
           "p5_dyngather_kernel", "p5_masksum_kernel",
           "p5_symbol_kernel", "p5_cluster_kernel", "p5_symbol_smem_kernel",
           "p5_row_kernel", "p5_masksum_vec_kernel",
           "p6_masksum_kernel", "p6_symbol_kernel", "p6_masksum_vec_kernel",
           "p6_symbol_smem_kernel", "p2_skel_vec_kernel",
           # P4's redesigns before the faithful names they contain
           "p4_reduce_pred_vec", "p4_cond_vec_vec", "p4_while22_vec",
           "p4_table_rw_vec", "p4_stage_store_vec", "p4_minscalar_vec",
           "p4_smem_scalar_vec", "p4_u64shift_vec", "p4_dma_row_vec",
           "reduce_pred", "cond_vec", "while22", "table_rw", "stage_store",
           "minscalar", "smem_scalar", "u64shift", "dma_row")
OPS = ("LDG", "LDS", "LDL", "LD", "STG", "STS", "STL", "ST", "ISETP", "SEL",
       "SHFL", "REDUX", "VOTE", "WARPSYNC")   # LD, ST: generic addresses

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def listing(binary: str = None) -> str:
    """``cuobjdump -sass`` of ``binary`` (by default the kernel library,
    built if need be)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if binary is None:
        kernels.lib()
        binary = kernels.build_info["path"]
    r = subprocess.run([tool, "-sass", binary], capture_output=True,
                       text=True, check=True)
    return r.stdout


def _kernel(mangled: str):
    """A kernel's name, with its bool template argument if it has one
    (``p1_sweep_kernel<true>``); None for other functions."""
    name = next((k for k in KERNELS if k in mangled), None)
    for arg, word in (("ILb1E", "<true>"), ("ILb0E", "<false>")):
        if name and arg in mangled:
            return name + word
    return name


def summarise(text: str) -> dict:
    """``{kernel: Counter}`` for the kernels in a SASS listing: each
    opcode in OPS (by its base name), ``insns``, ``loops`` (branches to
    an earlier address) and, as ``"loop " + opcode``, the opcodes of OPS
    that lie inside a loop (between a backward branch and its target)."""
    out, cur, spans = {}, None, {}
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = _kernel(m.group(1))
            cur = out.setdefault(name, Counter()) if name else None
            ops = spans.setdefault(name, ([], [])) if name else None
            continue
        m = _INSN.search(line)
        if cur is None or not m:
            continue
        addr, op, args = int(m.group(1), 16), m.group(2), m.group(3)
        if op == "NOP":
            continue
        cur["insns"] += 1
        base = op.split(".")[0]
        if base in OPS:
            cur[base] += 1
            ops[0].append((addr, base))
        t = re.search(r"0x([0-9a-f]+)", args)
        if base == "BRA" and t and int(t.group(1), 16) < addr:
            cur["loops"] += 1
            ops[1].append((int(t.group(1), 16), addr))
    for name, (opcodes, loops) in spans.items():
        for addr, base in opcodes:
            if any(lo <= addr <= hi for lo, hi in loops):
                out[name]["loop " + base] += 1
    return out


def main(argv=()) -> dict:
    text = listing(argv[1] if len(argv) > 1 else None)
    path = argv[0] if argv else None
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
    found = summarise(text)
    for k in KERNELS:
        names = sorted(n for n in found if n.split("<")[0] == k)
        if not names:
            print(f"{k}: not in the library", flush=True)
        for n in names:
            c = found[n]
            ops = " ".join(f"{o} {c[o]}" for o in OPS if c[o])
            print(f"{n}: {c['insns']} insns, {c['loops']} loops; {ops}",
                  flush=True)
    return found


if __name__ == "__main__":
    main(sys.argv[1:])
