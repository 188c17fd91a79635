"""Windows CE install-cabinet header tools.

Python equivalents of the reference perl tools
(reference: cabextract/src/wince_info, wince_rename): parse the MSCE
header file (`*.000`) found in WinCE installation cabinets, dump every
section (wince_info) or rename extracted `*.NNN` files to their
installed paths and emit a REGEDIT4 `setup.reg` (wince_rename).

Copied from ``libmspack_tpu/cli/wince.py`` unchanged (it imports nothing
of either package).
"""
from __future__ import annotations

import glob
import os
import shutil
import struct
import sys

ARCH = {
    0: "none", 103: "SHx SH3", 104: "SHx SH4", 386: "Intel 386",
    486: "Intel 486", 586: "Intel Pentium", 601: "PowerPC 601",
    603: "PowerPC 603", 604: "PowerPC 604", 620: "PowerPC 620",
    821: "Motorola 821", 0x720: "ARM 720", 0x820: "ARM 820",
    0x920: "ARM 920", 0xA11: "StrongARM", 4000: "MIPS R4000",
    10003: "Hitachi SH3", 10004: "Hitachi SH3E", 10005: "Hitachi SH4",
    21064: "Alpha 21064", 70001: "ARM 7TDMI",
}

CE_DIRS = [
    None, "\\Program Files", "\\Windows", "\\Windows\\Desktop",
    "\\Windows\\StartUp", "\\My Documents", "\\Program Files\\Accessories",
    "\\Program Files\\Communications", "\\Program Files\\Games",
    "\\Program Files\\Pocket Outlook", "\\Program Files\\Office",
    "\\Windows\\Programs", "\\Windows\\Programs\\Accessories",
    "\\Windows\\Programs\\Communications", "\\Windows\\Programs\\Games",
    "\\Windows\\Fonts", "\\Windows\\Recent", "\\Windows\\Favorites",
]

HKEYS = [None, "HKEY_CLASSES_ROOT", "HKEY_CURRENT_USER",
         "HKEY_LOCAL_MACHINE", "HKEY_USERS"]

MSCE_SIG = 0x4543534D


class MsceHeader:
    """Parsed MSCE header file (all six sections)."""

    def __init__(self, buf: bytes):
        if len(buf) < 100:
            raise ValueError("not a Windows CE install cabinet header")
        v = struct.unpack_from("<12I6H6I8H", buf, 0)
        if v[0] != MSCE_SIG:
            raise ValueError("not a Windows CE install cabinet header")
        self.raw = buf
        self.length = v[2]
        self.arch = v[5]
        self.min_version = (v[6], v[7], v[10])
        self.max_version = (v[8], v[9], v[11])
        self.counts = v[12:18]       # strings,dirs,files,hives,keys,links
        self.offsets = v[18:24]
        self.unknowns = (v[1], v[3], v[4], v[30], v[31])
        self.appname = self._string_at(v[24], v[25])
        self.provider = self._string_at(v[26], v[27])
        self.unsupported = self._string_at(v[28], v[29]) if v[29] else ""

        self.strings: dict[int, str] = {}
        pos = self.offsets[0]
        for _ in range(self.counts[0]):
            sid, slen = struct.unpack_from("<HH", buf, pos)
            self.strings[sid] = self._string_at(pos + 4, slen)
            pos += 4 + slen

        self.dirs: dict[int, str] = {}
        pos = self.offsets[1]
        for _ in range(self.counts[1]):
            did, dlen = struct.unpack_from("<HH", buf, pos)
            path = "\\".join(self._string_ids(pos + 4, dlen))
            for n in range(1, len(CE_DIRS)):
                path = path.replace(f"%CE{n}%", CE_DIRS[n])
            self.dirs[did] = path
            pos += 4 + dlen

        self.files: dict[int, tuple[str, int, int]] = {}
        pos = self.offsets[2]
        for _ in range(self.counts[2]):
            fid, dirid, unk, flags, flen = struct.unpack_from("<HHHIH", buf,
                                                              pos)
            name = self._string_at(pos + 12, flen)
            self.files[fid] = (f"{self.dirs[dirid]}\\{name}", unk, flags)
            pos += 12 + flen

        self.hives: dict[int, str] = {}
        pos = self.offsets[3]
        for _ in range(self.counts[3]):
            hid, root, _unk, hlen = struct.unpack_from("<HHHH", buf, pos)
            parts = [HKEYS[root] if 0 < root < len(HKEYS) else f"hive{root}"]
            parts += self._string_ids(pos + 8, hlen)
            self.hives[hid] = "\\".join(parts)
            pos += 8 + hlen

        # keys: (id, hive, subst, flags, name, payload)
        self.keys: list[tuple[int, int, int, int, str, bytes]] = []
        pos = self.offsets[4]
        for _ in range(self.counts[4]):
            kid, hive, subst, flags, klen = struct.unpack_from("<HHHIH", buf,
                                                               pos)
            data = buf[pos + 12:pos + 12 + klen]
            name, _, payload = data.partition(b"\x00")
            self.keys.append((kid, hive, subst, flags,
                              name.decode("latin-1"), payload))
            pos += 12 + klen

        # links: (id, unk, dest, src)
        self.links: list[tuple[int, int, str, str]] = []
        pos = self.offsets[5]
        for _ in range(self.counts[5]):
            lid, unk, ldir, fid, ltype, llen = struct.unpack_from(
                "<HHHHHH", buf, pos)
            name = "\\".join(self._string_ids(pos + 12, llen))
            if ldir == 0:
                dest = f"%InstallDir%\\{name}"
            elif 0 < ldir < len(CE_DIRS):
                dest = f"{CE_DIRS[ldir]}\\{name}"
            else:
                dest = name
            if ltype == 1:
                src = self.files[fid][0]
            elif fid == 0:
                src = "%InstallDir%"
            else:
                src = self.dirs[fid]
            self.links.append((lid, unk, dest, src))
            pos += 12 + llen

    def _string_at(self, off: int, length: int) -> str:
        return self.raw[off:off + length].rstrip(b"\x00").decode("latin-1")

    def _string_ids(self, off: int, length: int) -> list[str]:
        n = length // 2
        ids = struct.unpack_from(f"<{n}H", self.raw, off)[:-1]
        return [self.strings[i] for i in ids]


def _denull(s: str) -> str:
    return s.replace("\x00", ",")


def info(path: str, out=None) -> None:
    out = out or sys.stdout
    with open(path, "rb") as fh:
        hdr = MsceHeader(fh.read())
    p = lambda s: print(s, file=out)  # noqa: E731
    p(f"{path} HEADER")
    p(f"  length       = {hdr.length} bytes")
    p(f"  architecture = {ARCH.get(hdr.arch, 'unknown')} ({hdr.arch})")
    p(f"  counts       = {','.join(map(str, hdr.counts))}")
    p(f"  offsets      = {','.join(map(str, hdr.offsets))}")
    p(f"  unknowns     = {','.join(map(str, hdr.unknowns))}")
    mj, mn, bld = hdr.min_version
    p(f"  min WinCE v. = {mj}.{mn}" + (f" [build {bld}]" if bld else ""))
    mj, mn, bld = hdr.max_version
    p(f"  max WinCE v. = {mj}.{mn}" + (f" [build {bld}]" if bld else ""))
    p(f"  app name     = {hdr.appname}")
    p(f"  provider     = {hdr.provider}")
    if hdr.unsupported:
        p(f"  unsupported  = {_denull(hdr.unsupported)}")
    p(f"{path} STRINGS")
    for sid, s in sorted(hdr.strings.items()):
        p(f"  s{sid:02d}: {s}")
    p(f"{path} DIRS")
    for did, d in sorted(hdr.dirs.items()):
        p(f"  d{did:02d}: {d}")
    p(f"{path} FILES")
    for fid, (name, unk, flags) in sorted(hdr.files.items()):
        p(f"  f{fid:02d}: {name}")
        p(f"       unknown={unk} flags=0x{flags:08x}")
    p(f"{path} REGHIVES")
    for hid, h in sorted(hdr.hives.items()):
        p(f"  h{hid:02d}: {h}")
    p(f"{path} REGKEYS")
    for kid, hive, subst, flags, name, data in hdr.keys:
        p(f"  k{kid:02d}: hive={hdr.hives[hive]}")
        p(f"       name=<<{name}>> subst={subst} flags=0x{flags:08x}")
        kind = flags & 0x10001
        if kind == 0x10001:
            dword = struct.unpack_from("<I", data)[0]
            p(f"       [DWORD] {dword:08x} ({dword})")
        elif kind == 0x10000:
            for sz in data.decode("latin-1").split("\x00"):
                p(f"       [MULTI_SZ] <<{sz}>>")
        elif kind == 0x00001:
            p(f"       [BINARY] ({len(data)} bytes hexdump follows)")
            for i in range(0, len(data), 12):
                chunk = data[i:i + 12]
                hx = chunk.hex()
                hx = " ".join(hx[j:j + 8] for j in range(0, len(hx), 8))
                txt = "".join(chr(c) if 32 <= c < 127 else "."
                              for c in chunk)
                p(f"       {hx:<28s}{txt}")
        else:
            p(f"       [SZ] {data[:-1].decode('latin-1')}")
    p(f"{path} LINKS")
    for lid, unk, dest, src in hdr.links:
        p(f"  l{lid:02d}: src=<<{src}>>")
        p(f"       dest=<<{dest}>>  (unk={unk})")


def _win32_to_local(path: str) -> str:
    parts = [p for p in path.split("\\") if p]
    return os.path.join(*parts) if parts else ""


def _get_fname(num: int, directory: str = ".") -> str | None:
    matches = sorted(glob.glob(os.path.join(directory, f"*.{num:03d}")))
    if len(matches) > 1:
        print(f"WARNING: more than one '*.{num:03d}' file, "
              f"using '{matches[0]}'", file=sys.stderr)
    return matches[0] if matches else None


def _move(src: str, dest: str) -> None:
    print(f'moving "{src}" to "{dest}"')
    d = os.path.dirname(dest)
    if d:
        os.makedirs(d, exist_ok=True)
    shutil.move(src, dest)


def rename(directory: str = ".") -> int:
    """wince_rename in `directory`: rename *.NNN to installed names,
    *.000 -> header.bin, *.999 -> setup.dll, write setup.reg."""
    hdrfile = _get_fname(0, directory)
    if hdrfile is None:
        print("no header (*.000) file found")
        return 0
    with open(hdrfile, "rb") as fh:
        try:
            hdr = MsceHeader(fh.read())
        except ValueError as e:
            print(f"{hdrfile}: {e}")
            hdr = None
    if hdr is not None:
        print(f"Appname:  {hdr.appname}")
        print(f"Provider: {hdr.provider}")
        for fid, (winpath, _unk, _flags) in sorted(hdr.files.items()):
            src = _get_fname(fid, directory)
            if src:
                _move(src, os.path.join(directory,
                                        _win32_to_local(winpath)))
        if hdr.keys:
            _write_reg(hdr, os.path.join(directory, "setup.reg"))
    _move(hdrfile, os.path.join(directory, "header.bin"))
    dll = _get_fname(999, directory)
    if dll:
        _move(dll, os.path.join(directory, "setup.dll"))
    return 0


def _write_reg(hdr: MsceHeader, path: str) -> None:
    short = {1: "HKCR", 2: "HKCU", 3: "HKLM", 4: "HKEY_USERS"}
    hives = {}
    for hid, full in hdr.hives.items():
        parts = full.split("\\")
        root = next((k for k, v in enumerate(HKEYS) if v == parts[0]), None)
        head = short.get(root, parts[0])
        hives[hid] = "\\".join([head] + parts[1:])
    with open(path, "w", newline="") as fh:
        fh.write("REGEDIT4\r\n")
        lasthive = -1
        for _kid, hive, _subst, flags, name, data in hdr.keys:
            if lasthive != hive:
                fh.write(f"\r\n[{hives[hive]}]\r\n")
            lasthive = hive
            fh.write("@" if name == "" else f'"{name}"')
            fh.write("=")
            kind = flags & 0x10001
            if kind == 0x10001:
                fh.write("dword:%08x" % struct.unpack_from("<I", data)[0])
            elif kind == 0x00001:
                fh.write("hex:" + ",".join(f"{b:02x}" for b in data))
            else:
                s = data[:-1]
                if kind == 0x10000:
                    s = s[:-1]
                txt = (s.decode("latin-1").replace("\\", "\\\\")
                       .replace("\x00", "\\0").replace('"', '\\"'))
                fh.write(f'"{txt}"')
            fh.write("\r\n")


def main_info(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    for path in args:
        try:
            info(path)
        except (OSError, ValueError) as e:
            print(f"{path}: {e}", file=sys.stderr)
    return 0


def main_rename(argv: list[str] | None = None) -> int:
    return rename(".")


if __name__ == "__main__":
    if os.path.basename(sys.argv[0]).startswith("wince_rename") or \
            (len(sys.argv) > 1 and sys.argv[1] == "--rename"):
        sys.exit(main_rename(sys.argv[2:]))
    sys.exit(main_info())
