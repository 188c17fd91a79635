"""Inputs of the benchmark, made from the seed: plaintext (``data``), the
frozen encoders (``encoders``) and archive writers (``archives``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Item:
    """One unit of work of a cell: the archives handed to the program, the
    files each must give (``{name: bytes}`` per archive), and the bytes
    each codec's kernel reads and writes for them
    (``{codec: [compressed, plaintext]}``)."""
    inputs: list
    expected: list
    kernel_bytes: dict

    @property
    def plain_bytes(self) -> int:
        return sum(len(b) for files in self.expected for b in files.values())

    @property
    def input_bytes(self) -> int:
        return sum(len(a) for a in self.inputs)
