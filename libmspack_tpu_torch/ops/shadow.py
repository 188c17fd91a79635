"""Shadow checks: K1, K3 and K4 held to their plain versions where they
launch.

Inside ``with shadow.active() as errs:``, each launch of K1
(``cuda_inflate.inflate_phase_a``), K3 (``cuda_lzx.lzx_phase_a``) or K4
(``cuda_qtm.qtm_phase_a``) on a card also runs the kernel's plain version
on CPU copies of the same inputs (a passed state record included), and
``errs[name]`` keeps the largest absolute difference over all of that
kernel's launches: of the counts, the state records, and the tokens and
literal words below the plain version's token count of each lane. A path
run this way is held to the plain versions at the very shapes it gives
the kernels (the multi-device decode of ``parallel/mesh.py``, for one).
The plain runs are not counted in ``LAUNCHES``. Outside such a block, or
on CPU tensors (which take the plain versions anyway), nothing changes.
"""
from __future__ import annotations

import contextlib

import torch

_errs: dict | None = None


@contextlib.contextmanager
def active():
    """Shadow-check every kernel launch inside the block; yields the dict
    of largest differences by kernel name ("k1_inflate", "k3_lzx",
    "k4_qtm", as in ``chip_smoke.py``'s kernels line)."""
    global _errs
    prev, _errs = _errs, {}
    try:
        yield _errs
    finally:
        _errs = prev


def inputs(*tensors):
    """CPU copies of a launch's inputs (None stays None) while a block is
    active; None otherwise. Taken before the launch, which may update a
    state record in place."""
    if _errs is None:
        return None
    return [None if t is None else t.detach().to("cpu", copy=True)
            for t in tensors]


def difference(got, want, rows: int = 8) -> int:
    """Largest absolute difference between a kernel's outputs ``got`` and
    its plain version's ``want`` (each ``(tok, litw, cnt[, state])``):
    the first ``rows`` count rows, the state records where both have one,
    and tokens and literal words below the plain token count."""
    tok, litw, cnt = (t.cpu().long() for t in got[:3])
    wtok, wlitw, wcnt = (t.long() for t in want[:3])
    err = int((cnt[:rows] - wcnt[:rows]).abs().max()) if cnt.numel() else 0
    if len(got) > 3 and len(want) > 3 and want[3].numel():
        err = max(err, int((got[3].cpu().long() - want[3].long())
                           .abs().max()))
    live = torch.arange(wtok.shape[1])[None, :] < wcnt[2][:, None]
    for a, b in ((tok, wtok), (litw, wlitw)):
        if a.numel():
            err = max(err, int(torch.where(live, (a - b).abs(), 0).max()))
    return err


def record(name: str, got, want, rows: int = 8) -> None:
    """Keep ``difference(got, want, rows)`` for kernel ``name``."""
    _errs[name] = max(_errs.get(name, 0), difference(got, want, rows))
