"""The port's fuzz runner (``libmspack_tpu_torch/tools/fuzz_mass.py``).

A few seeded rounds per format with ``engine="cuda", device="cpu"`` (the
kernels' plain versions): no foreign exception, and every member whose
bytes both the engine and the port's ``"scalar"`` engine return is equal.
The runner's archives and mutations are the JAX runner's
(``tools/fuzz_mass.py``) byte for byte where both build them, and its pass
rules count what they should.
"""
import random

import pytest

from tools import fuzz_mass as jax_fuzz

from libmspack_tpu_torch.tools import fuzz_mass

ROUNDS = {"cab": 10, "chm": 4, "oab": 10, "szdd": 10, "kwaj": 10}


@pytest.fixture(scope="module")
def archives():
    return fuzz_mass.build_archives()


@pytest.mark.parametrize("kind", sorted(ROUNDS))
def test_sweep_is_clean_on_the_plain_versions(kind, archives):
    r = fuzz_mass.sweep(kind, archives[kind], ROUNDS[kind], seed=3,
                        engine="cuda", device="cpu")
    assert r["done"] == ROUNDS[kind]
    assert r["fails"] == [] and r["cuda_errors"] == []
    assert r["mismatches"] == []


@pytest.mark.parametrize("kind", ["cab", "szdd", "kwaj", "oab"])
def test_archives_and_mutations_are_the_jax_runners(kind, archives):
    want = jax_fuzz.build_archives()[kind]
    assert archives[kind] == want
    a, b = random.Random(9), random.Random(9)
    for _ in range(20):
        assert fuzz_mass.mutate(a, want) == jax_fuzz.mutate(b, want)


@pytest.mark.parametrize("kind", ["cab", "chm", "szdd", "oab"])
def test_unmutated_archive_extracts_equal(kind, archives):
    got = fuzz_mass.drive(kind, archives[kind], "cuda", "cpu")
    assert got == fuzz_mass.drive(kind, archives[kind], "scalar", "cpu")
    assert got and all(isinstance(x, bytes) for x in got)


def test_sweep_counts_each_rule(monkeypatch):
    """A foreign exception is a failure; a member whose bytes differ from
    the scalar engine's is a mismatch; a differing error class is
    counted, not failed."""
    runs = iter([ValueError("boom"),
                 [b"x", "ReadError"], [b"x", "ChecksumError"],
                 [b"y"], [b"z"]])

    def drive(kind, blob, engine, device):
        got = next(runs)
        if isinstance(got, Exception):
            raise got
        return got

    monkeypatch.setattr(fuzz_mass, "drive", drive)
    r = fuzz_mass.sweep("cab", b"MSCF" * 64, 3, seed=0, device="cpu")
    assert r["done"] == 3
    assert [f[1] for f in r["fails"]] == ["ValueError"]
    assert r["class_diffs"] == {("ReadError", "ChecksumError"): 1}
    assert r["mismatches"] == [2]
