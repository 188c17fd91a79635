"""cabinfo: CAB structure dumper (reference: cabextract/src/cabinfo.c).

Prints header, folder and file structures plus CFDATA block headers.

Copied from ``libmspack_tpu/cli/cabinfo.py``; besides the imports, the
cabinet is parsed with ``engine="scalar"`` (the port's driver defaults to
the card, and this tool decodes nothing).

    python -m libmspack_tpu_torch.cli.cabinfo CAB...
"""
from __future__ import annotations

import sys

from ..errors import MSPackError
from ..formats.cab import CFDATA_SIZEOF, CabDecompressor
from ..system import open_source, read_exact


def dump(path: str) -> int:
    d = CabDecompressor(engine="scalar")
    try:
        cab = d.open(path)
    except MSPackError as e:
        print(f"{path}: {e}", file=sys.stderr)
        return 1
    print(f"*** {path}")
    print(f"CAB size        = {cab.length}")
    print(f"set ID          = 0x{cab.set_id:04x}  index = {cab.set_index}")
    print(f"flags           = 0x{cab.flags:04x}")
    print(f"header reserve  = {cab.header_resv}  block reserve = "
          f"{cab.block_resv}")
    if cab.prevname:
        print(f"prev cabinet    = {cab.prevname} ({cab.previnfo})")
    if cab.nextname:
        print(f"next cabinet    = {cab.nextname} ({cab.nextinfo})")
    print(f"\n[folders]  count = {len(cab.folders)}")
    for i, fol in enumerate(cab.folders):
        print(f"  folder {i}: comp={fol.compression_name} "
              f"(0x{fol.comp_type:04x}) blocks={fol.num_blocks} "
              f"offset={fol.data[0].offset}")
    print(f"\n[files]  count = {len(cab.files)}")
    for f in cab.files:
        fidx = next((i for i, fol in enumerate(cab.folders)
                     if fol is f.folder), -1)
        print(f"  {f.length:10d} folder={fidx} offset={f.offset:<10d} "
              f"{f.date_y:04d}-{f.date_m:02d}-{f.date_d:02d} "
              f"{f.time_h:02d}:{f.time_m:02d}:{f.time_s:02d} "
              f"attribs=0x{f.attribs:02x} {f.filename}")
    # walk the data blocks of each folder
    src = open_source(path)
    for i, fol in enumerate(cab.folders):
        print(f"\n[folder {i} data blocks]")
        src.seek(fol.data[0].offset)
        for b in range(fol.num_blocks):
            try:
                hdr = read_exact(src, CFDATA_SIZEOF)
            except MSPackError:
                print("  (truncated)")
                break
            cksum = int.from_bytes(hdr[0:4], "little")
            clen = int.from_bytes(hdr[4:6], "little")
            ulen = int.from_bytes(hdr[6:8], "little")
            print(f"  block {b}: csum=0x{cksum:08x} csize={clen} usize={ulen}")
            src.seek(clen + cab.block_resv, 1)
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: cabinfo <cabfile>...", file=sys.stderr)
        return 1
    rc = 0
    for path in argv:
        rc |= dump(path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
