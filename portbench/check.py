"""How ``correct`` is decided: every file that a sampled item delivered is
compared byte for byte with the plaintext the generator packed into its
archive. The limits are 0: the formats' guarantee is exact delivery.

The control puts the reference in the program's place and breaks one
guarantee: it withholds the last 32 KiB frame of every archive's output
(zeros in its place), as a decoder that skips its final flush would.
"""
from __future__ import annotations

import numpy as np

FRAME = 32768
LIMITS = {"items_failed": 0, "files_wrong": 0, "bytes_wrong": 0}


def bytes_wrong(got, want: bytes) -> int:
    """Bytes of ``want`` that ``got`` does not hold at the same place,
    missing bytes and extra bytes counted too."""
    if got is None:
        return len(want)
    if got == want:
        return 0
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int((a != b).sum()) + abs(len(got) - len(want))


def compare(delivered: list, expected: list) -> tuple[int, int, int]:
    """(files checked, files wrong, bytes wrong) of one item's delivered
    archives against the generator's."""
    checked = wrong = nbytes = 0
    for i, want in enumerate(expected):
        got = delivered[i] if i < len(delivered) else {}
        for name, data in want.items():
            checked += 1
            bad = bytes_wrong(got.get(name), data)
            if bad:
                wrong += 1
                nbytes += bad
        extra = set(got) - set(want)
        wrong += len(extra)
        nbytes += sum(len(got[n]) for n in extra)
    return checked, wrong, nbytes


def control(item) -> list:
    """The reference's files with the last frame of each archive zeroed."""
    out = []
    for files in item.expected:
        names = list(files)
        blob = bytearray(b"".join(files[n] for n in names))
        cut = max(0, len(blob) - FRAME)
        blob[cut:] = bytes(len(blob) - cut)
        got, at = {}, 0
        for n in names:
            got[n] = bytes(blob[at:at + len(files[n])])
            at += len(files[n])
        out.append(got)
    return out
