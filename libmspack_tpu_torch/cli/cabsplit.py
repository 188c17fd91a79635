"""cabsplit — split a cabinet into one cabinet per folder.

Python equivalent of the reference perl tool
(reference: cabextract/src/cabsplit): each folder's CFDATA chain and its
files become a standalone single-folder cabinet named `<input>.NNN`.
Reserved header/folder/block areas are dropped; merge-marker folder
indices (0xFFFD/0xFFFE/0xFFFF) are remapped to the local folder.

Copied from ``libmspack_tpu/cli/cabsplit.py`` unchanged (it imports
nothing of either package).

    python -m libmspack_tpu_torch.cli.cabsplit CAB...
"""
from __future__ import annotations

import struct
import sys


def _read_string(buf: bytes, pos: int) -> tuple[bytes, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end], end + 1


def split_cabinet(path: str) -> str | None:
    """Split one cabinet; returns an error string or None on success."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if len(buf) < 36:
        return "not a cab file"
    sig, _r1, _cablen, _r2, _fileoff, _r3, vmin, vmaj, nfolders, nfiles, \
        flags, setid, setidx = struct.unpack_from("<IIIIIIBBHHHHH", buf, 0)
    if sig != 0x4643534D:
        return "not a cab file"
    pos = 36
    folder_resv = block_resv = 0
    if flags & 0x0004:
        hdr_resv, folder_resv, block_resv = struct.unpack_from("<HBB", buf,
                                                               pos)
        pos += 4 + hdr_resv
    if flags & 0x0001:
        _, pos = _read_string(buf, pos)
        _, pos = _read_string(buf, pos)
    if flags & 0x0002:
        _, pos = _read_string(buf, pos)
        _, pos = _read_string(buf, pos)

    folders = []
    for _ in range(nfolders):
        folders.append(buf[pos:pos + 8])
        pos += 8 + folder_resv

    per_folder_files: list[list[bytes]] = [[] for _ in range(nfolders)]
    for _ in range(nfiles):
        entry = buf[pos:pos + 16]
        folder = struct.unpack_from("<H", entry, 8)[0]
        name, npos = _read_string(buf, pos + 16)
        if folder in (0xFFFD, 0xFFFF):
            folder = 0
        elif folder == 0xFFFE:
            folder = nfolders - 1
        per_folder_files[folder].append(
            entry[:8] + b"\x00\x00" + entry[10:16] + name + b"\x00")
        pos = npos

    for i, fol in enumerate(folders):
        offset, cnt, comp = struct.unpack("<IHH", fol)
        blocks = bytearray()
        bpos = offset
        for _ in range(cnt):
            csize = struct.unpack_from("<H", buf, bpos + 4)[0]
            blocks += buf[bpos:bpos + 8]
            bpos += 8 + block_resv
            blocks += buf[bpos:bpos + csize]
            bpos += csize
        files = b"".join(per_folder_files[i])

        out = bytearray()
        cablen = 36 + 8 + len(files) + len(blocks)
        out += struct.pack("<IIIIIIBBHHHHH", sig, 0, cablen, 0, 36 + 8, 0,
                           vmin, vmaj, 1, len(per_folder_files[i]), 0,
                           setid, setidx)
        out += struct.pack("<IHH", 36 + 8 + len(files), cnt, comp)
        out += files
        out += blocks
        outname = f"{path}.{i + 1:03d}"
        try:
            with open(outname, "wb") as ofh:
                ofh.write(out)
        except OSError as e:
            return f"can't create {outname}: {e}"
    return None


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(f"Usage: {sys.argv[0]} <cab file(s)>", file=sys.stderr)
        return 1
    for path in args:
        try:
            err = split_cabinet(path)
        except (OSError, ValueError, struct.error) as e:
            err = str(e)
        if err:
            print(f"{path}: {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
