"""The share of a patch's reference data served on the device path: the
LZX engines' ``ref_bytes`` (the reference bytes of the lanes that K3
decoded and host phase B resolved) over the OAB driver's ``base_bytes``
(the reference bytes its batches read from the base). None where the
program keeps no such counter."""


def read(run):
    if not run.has("base_bytes") or not run.total("base_bytes"):
        return None
    return 100.0 * run.total("ref_bytes") / run.total("base_bytes")
