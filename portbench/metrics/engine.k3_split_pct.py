"""The share of the window's LZX plaintext that K3's frame lanes decoded:
the LZX engines' ``k3_split_bytes`` (output bytes of the folders decoded a
warp per 32 KiB frame) over the plaintext bytes of the LZX folders or
blocks that the window completed, counted from the archives. None where
the program keeps no such counter."""


def read(run):
    plain = run.kernel_bytes("lzx")[1]
    if not run.has("k3_split_bytes") or not plain:
        return None
    return 100.0 * run.total("k3_split_bytes") / plain
