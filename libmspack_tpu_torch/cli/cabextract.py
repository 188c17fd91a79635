"""cabextract-compatible CLI (L5).

Re-implements the reference front-end's behavior (reference:
cabextract/src/cabextract.c): search -> load spanning cabinets ->
filter -> list/test/extract, with the same output formats the golden
CLI tests pin down (cabextract/test/*.test) and the same output-name
sanitisation rules (UTF-8 re-encode, slash normalisation, leading-slash
strip, "../" -> "xx"; cabextract.c:792-935).

Extras over the reference: --engine selects the decode engine and
--device the device of --engine cuda.

Copied from ``libmspack_tpu/cli/cabextract.py``. Besides the imports: the
engines are the port's (``cuda``, the default, decodes on ``--device``,
itself ``cuda`` by default; ``native``, ``scalar`` and ``auto``, the native
engine where it builds); ``--engine cuda`` on a device that cannot run
stops with a usage error before any cabinet is read; the ``--version``
suffix and the description name the port. Every other option and message
is the JAX CLI's.

    python -m libmspack_tpu_torch.cli.cabextract [-l|-t|-p] [-d DIR] CAB...
"""
from __future__ import annotations

import argparse
import fnmatch
import hashlib
import os
import stat
import sys
import time

from .._device import resolve_device
from ..errors import MSPackError
from ..formats.cab import CabDecompressor, Cabinet
from ..system import FileSink, HashSink, Sink


def unix_path_separators(files) -> bool:
    """reference: cabextract.c:720-775."""
    slash = backslash = False
    for f in files:
        for ch in f.filename:
            if ch == "/":
                slash = True
            if ch == "\\":
                backslash = True
        if slash and backslash:
            break
    if slash and not backslash:
        return True
    if not slash:
        return False
    if len(files) == 1:
        for c in files[0].filename:
            if c == "\\":
                return False
            if c == "/":
                return True
        return False
    oldname, oldlen = None, 0
    for f in files:
        name = f.filename
        length = 0
        while length < len(name) and name[length] not in "\\/":
            length += 1
        if length >= len(name):
            length = 0
        else:
            length += 1
        if length and length == oldlen and oldname is not None:
            if name[:length] == oldname[:length]:
                return name[length - 1] != "\\"
        oldname, oldlen = name, length
    return False


def create_output_name(fname: str, directory: str | None, lower: bool,
                       isunix: bool, utf8: bool) -> str:
    """reference: cabextract.c:792-935 (sanitisation is load-bearing)."""
    sep = "/" if isunix else "\\"
    slash = "\\" if isunix else "/"
    raw = fname.encode("latin-1", "replace")

    out_chars: list[int] = []
    if utf8:
        i, n = 0, len(raw)
        while i < n:
            c = raw[i]
            i += 1
            if c < 0x80:
                x = c
            elif (0xC2 <= c < 0xE0 and i < n and (raw[i] & 0xC0) == 0x80):
                x = ((c & 0x1F) << 6) | (raw[i] & 0x3F)
                i += 1
            elif (0xE0 <= c < 0xF0 and i + 1 < n
                  and (raw[i] & 0xC0) == 0x80 and (raw[i + 1] & 0xC0) == 0x80):
                x = ((c & 0x0F) << 12) | ((raw[i] & 0x3F) << 6) \
                    | (raw[i + 1] & 0x3F)
                i += 2
            elif (0xF0 <= c < 0xF5 and i + 2 < n
                  and (raw[i] & 0xC0) == 0x80 and (raw[i + 1] & 0xC0) == 0x80
                  and (raw[i + 2] & 0xC0) == 0x80):
                x = ((c & 0x07) << 18) | ((raw[i] & 0x3F) << 12) \
                    | ((raw[i + 1] & 0x3F) << 6) | (raw[i + 2] & 0x3F)
                i += 3
            else:
                x = 0xFFFD
            if (x <= 0 or x > 0x10FFFF or 0xD800 <= x <= 0xDFFF
                    or x in (0xFFFE, 0xFFFF)):
                x = 0xFFFD
            if lower:
                x = ord(chr(x).lower()[0])
            if chr(x) == sep:
                x = ord("/")
            elif chr(x) == slash:
                x = ord("\\")
            out_chars.append(x)
        name = "".join(chr(x) for x in out_chars)
    else:
        chars = []
        for c in raw:
            ch = chr(c)
            if lower:
                ch = ch.lower()
            if ch == sep:
                ch = "/"
            elif ch == slash:
                ch = "\\"
            chars.append(ch)
        name = "".join(chars)

    # strip leading slashes (prevents absolute paths)
    stripped = name.lstrip("/\\")
    if stripped != name:
        name = stripped if stripped else "x"

    # neutralise "../" and "..\" (prevents traversal)
    chars = list(name)
    i = 0
    while i < len(chars):
        if (chars[i] == "." and i + 2 < len(chars) + 1
                and i + 1 < len(chars) and chars[i + 1] == "."
                and i + 2 < len(chars) and chars[i + 2] in "/\\"):
            chars[i] = chars[i + 1] = "x"
            i += 3
        else:
            i += 1
    name = "".join(chars)

    if directory:
        name = directory.rstrip("/") + "/" + name
    return name


def _find_cabinet_file(base_path: str, cabname: str) -> str | None:
    """Case-insensitive sibling lookup (reference: cabextract.c:652-698)."""
    d = os.path.dirname(base_path) or "."
    tail = cabname.replace("\\", "/").split("/")[-1]
    cand = os.path.join(d, tail)
    if os.path.isfile(cand):
        return cand
    try:
        for entry in os.listdir(d):
            if entry.lower() == tail.lower():
                p = os.path.join(d, entry)
                if os.path.isfile(p):
                    return p
    except OSError:
        pass
    return None


def load_spanning_cabinets(cabd: CabDecompressor, basecab: Cabinet,
                           base_path: str, quiet: bool) -> None:
    cab = basecab
    while cab.flags & 0x0001:  # PREV_CABINET
        name = _find_cabinet_file(base_path, cab.prevname)
        if not name:
            print(f"{base_path}: can't find {cab.prevname}", file=sys.stderr)
            break
        if not quiet:
            print(f"{base_path}: extends backwards to {cab.prevname} "
                  f"({cab.previnfo})")
        try:
            cab2 = cabd.open(name)
            cabd.prepend(cab, cab2)
        except MSPackError as e:
            print(f"{base_path}: can't prepend {cab.prevname}: {e}",
                  file=sys.stderr)
            break
        cab = cab.prevcab
    cab = basecab
    while cab.flags & 0x0002:  # NEXT_CABINET
        name = _find_cabinet_file(base_path, cab.nextname)
        if not name:
            print(f"{base_path}: can't find {cab.nextname}", file=sys.stderr)
            break
        if not quiet:
            print(f"{base_path}: extends to {cab.nextname} ({cab.nextinfo})")
        try:
            cab2 = cabd.open(name)
            cabd.append(cab, cab2)
        except MSPackError as e:
            print(f"{base_path}: can't append {cab.nextname}: {e}",
                  file=sys.stderr)
            break
        cab = cab.nextcab


def _ensure_filepath(path: str, archive_offset: int,
                     keep_symlinks: bool) -> bool:
    """Create the directories leading to `path`. In the
    archive-controlled part of the path (beyond archive_offset),
    symlinked directories are REMOVED and replaced with real ones
    unless -k; symlinks in the user-supplied -d prefix are honoured
    (reference: cabextract.c:1211-1238, pinned by symlinks.test)."""
    global _UMASK
    if _UMASK is None:
        _UMASK = os.umask(0)
        os.umask(_UMASK)
    for i in range(1, len(path)):
        if path[i] != "/":
            continue
        prefix = path[:i]
        if i < archive_offset or keep_symlinks:
            ok = os.path.isdir(prefix)
        else:
            try:
                st = os.lstat(prefix)
                if stat.S_ISLNK(st.st_mode):
                    os.unlink(prefix)
                ok = stat.S_ISDIR(st.st_mode)
            except OSError:
                ok = False
        if not ok:
            try:
                os.mkdir(prefix, 0o777 & ~_UMASK)
            except OSError:
                return False
    return True


def convert_filenames(files, encoding: str) -> None:
    """-e: convert non-UTF8 cab filenames from the given charset to
    UTF-8 before output-name generation (reference: cabextract.c
    convert_filenames; invalid sequences become U+FFFD)."""
    for f in files:
        if f.attribs & 0x80:      # already flagged UTF-8
            continue
        raw = f.filename.encode("latin-1", "replace")
        try:
            conv = raw.decode(encoding, "replace")
        except LookupError:
            raise SystemExit(f"cabextract: bad encoding {encoding!r}")
        # re-materialise as the byte-transparent latin-1 carrier the
        # sanitiser consumes, now holding UTF-8 bytes
        f.filename = conv.encode("utf-8").decode("latin-1")
        f.attribs |= 0x80


_INTERACTIVE_ANSWER = {"value": ""}


def can_write(name: str, args) -> bool:
    """Overwrite policy (reference: cabextract.c:954-990): -n never
    overwrites, -i prompts ([y]es/[n]o/[A]ll/[N]one), and unless -k is
    given an existing file is unlink()ed first so symlinks are removed
    rather than written through."""
    if not os.path.lexists(name):
        return True
    if args.no_overwrite:
        return False
    if args.interactive:
        ans = _INTERACTIVE_ANSWER["value"]
        if ans.startswith("N"):
            return False
        if not ans.startswith("A"):
            while True:
                try:
                    reply = input(f"replace {name}? [y]es, [n]o, "
                                  "[A]ll, [N]one: ")
                except EOFError:
                    return False
                if reply[:1] in ("n", "N", "y", "A"):
                    if reply[:1] in ("N", "A"):
                        _INTERACTIVE_ANSWER["value"] = reply[:1]
                    if reply[:1] in ("n", "N"):
                        return False
                    break
                print(f'invalid response "{reply}", type y, n, A or N')
    if not args.keep_symlinks:
        try:
            os.unlink(name)
        except OSError as e:
            print(f"can't remove old {name}: {e}", file=sys.stderr)
            return False
    return True


_UMASK = None


def set_date_and_perm(file, name: str) -> None:
    """reference: cabextract.c:999-1031."""
    global _UMASK
    if _UMASK is None:
        _UMASK = os.umask(0)
        os.umask(_UMASK)
    try:
        t = time.mktime((file.date_y, file.date_m, file.date_d,
                         file.time_h, file.time_m, file.time_s, 0, 0, -1))
        os.utime(name, (t, t))
    except (OverflowError, ValueError, OSError):
        pass
    mode = 0o444
    if file.attribs & 0x40:          # MSCAB_ATTRIB_EXEC
        mode |= 0o111
    if not (file.attribs & 0x01):    # MSCAB_ATTRIB_RDONLY
        mode |= 0o222
    try:
        os.chmod(name, mode & ~_UMASK)
    except OSError:
        pass


class _StdoutSink:
    def write(self, data) -> int:
        sys.stdout.buffer.write(data)
        return len(data)


def process_cabinet(cab_path: str, args) -> int:
    """reference: cabextract.c:418-584. Returns error count."""
    cabd = CabDecompressor(message=lambda s: print(s, file=sys.stderr),
                           engine=args.engine, device=args.device)
    if args.fix:
        cabd.set_param(1, 1)  # FIXMSZIP
        cabd.set_param(3, 1)  # SALVAGE
    errors = 0
    try:
        basecab = cabd.search(cab_path)
    except MSPackError as e:
        print(f"{cab_path}: {e}", file=sys.stderr)
        return 1
    if basecab is None:
        print(f"{cab_path}: no valid cabinets found", file=sys.stderr)
        return 1

    viewhdr = False
    cab = basecab
    while cab is not None:
        if not args.single:
            load_spanning_cabinets(cabd, cab, cab_path, args.quiet)

        if args.encoding:
            convert_filenames(cab.files, args.encoding)
        isunix = unix_path_separators(cab.files)

        if not viewhdr:
            if args.view:
                if not args.quiet:
                    print(f"Viewing cabinet: {cab_path}")
                print(" File size | Date       Time     | Name")
                print("-----------+---------------------+-------------")
            else:
                if not args.quiet:
                    mode = "Testing" if args.test else "Extracting"
                    print(f"{mode} cabinet: {cab_path}")
            viewhdr = True

        fname_offset = len(args.dir) + 1 if args.dir else 0

        for file in cab.files:
            name = create_output_name(file.filename, args.dir,
                                      args.lower, isunix,
                                      bool(file.attribs & 0x80))
            if args.filters:
                inner = name[fname_offset:]
                if not any(fnmatch.fnmatch(inner.lower(), f.lower())
                           for f in args.filters):
                    continue

            if args.view:
                print("%10d | %02d.%02d.%04d %02d:%02d:%02d | %s" % (
                    file.length, file.date_d, file.date_m, file.date_y,
                    file.time_h, file.time_m, file.time_s, name))
            elif args.test:
                sink = HashSink("md5")
                try:
                    cabd.extract(file, sink)
                except MSPackError as e:
                    print(f"  {name}  failed ({e})")
                    errors += 1
                else:
                    spaces = 79 - (len(name) + 8 + 32)
                    pad = " " * max(0, spaces)
                    print(f"  {name}  OK  {pad}{sink.hexdigest()}")
            else:
                if args.pipe:
                    try:
                        cabd.extract(file, _StdoutSink())
                    except MSPackError as e:
                        print(f"stdout({name}): {e}", file=sys.stderr)
                        errors += 1
                else:
                    if not args.quiet:
                        print(f"  extracting {name}")
                    if not _ensure_filepath(name, fname_offset,
                                            args.keep_symlinks):
                        print(f"{name}: can't create file path",
                              file=sys.stderr)
                        errors += 1
                        continue
                    if not can_write(name, args):
                        continue
                    try:
                        sink = FileSink(name)
                        try:
                            cabd.extract(file, sink)
                        finally:
                            sink.close()
                        set_date_and_perm(file, name)
                    except MSPackError as e:
                        print(f"{name}: {e}", file=sys.stderr)
                        errors += 1
        cab = cab.next
    return errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cabextract",
        description="Extract Microsoft cabinet files (PyTorch + CUDA "
                    "engine)")
    p.add_argument("cabinets", nargs="+", help="cabinet files")
    p.add_argument("-d", "--directory", dest="dir", default=None,
                   help="extract into this directory")
    p.add_argument("-f", "--fix", action="store_true",
                   help="salvage damaged cabinets (fix MSZIP, ignore checks)")
    p.add_argument("-F", "--filter", dest="filters", action="append",
                   default=[], help="extract only matching files")
    p.add_argument("-l", "--list", dest="view", action="store_true",
                   help="list contents")
    p.add_argument("-t", "--test", action="store_true",
                   help="test integrity (prints MD5s)")
    p.add_argument("-L", "--lowercase", dest="lower", action="store_true",
                   help="lowercase filenames")
    p.add_argument("-p", "--pipe", action="store_true",
                   help="extract to stdout")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-s", "--single", action="store_true",
                   help="don't load spanning cabinets")
    p.add_argument("-e", "--encoding", default=None,
                   help="assume non-UTF8 filenames use this charset")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="ask before overwriting files")
    p.add_argument("-n", "--no-overwrite", dest="no_overwrite",
                   action="store_true", help="never overwrite files")
    p.add_argument("-k", "--keep-symlinks", dest="keep_symlinks",
                   action="store_true",
                   help="don't remove existing symlinks before writing")
    p.add_argument("-v", "--version", action="version",
                   version="cabextract 1.11 (libmspack_tpu_torch)")
    p.add_argument("--engine", default="cuda",
                   choices=["cuda", "native", "scalar", "auto"],
                   help="decode engine (cuda = the CUDA kernels on --device)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of --engine cuda")
    args = p.parse_args(argv)
    if args.engine == "cuda":
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            p.error(str(e))

    errors = 0
    for cab in args.cabinets:
        errors += process_cabinet(cab, args)

    if not args.quiet:
        if errors:
            print(f"\nAll done, errors in processing {errors} file(s)")
        else:
            print("\nAll done, no errors.")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
