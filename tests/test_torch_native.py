"""utils/native.py of the PyTorch port (csrc/marshal.c, built with the host
C compiler) against the port's numpy marshaling and, repacked to 16-bit
limbs, the JAX reference's ``ints_to_limbs``; and ``ints_to_words`` /
``words_to_ints`` (numpy) against the library, loaded or not.  Inputs: seeded
random ints below 2^256 with 0, 1 and 2^256 - 1 among them; tolerance:
exact.  Skips only where there is no host C compiler."""

import random
import shutil

import numpy as np
import pytest
import torch

from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.utils import bigint, native

torch.set_num_threads(1)

N = 257


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The library built into a temporary build root and loaded; the
    module's state is restored after."""
    if not any(shutil.which(c) for c in ("cc", "gcc", "clang")):
        pytest.skip("no host C compiler")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_ROOT", tmp_path_factory.mktemp("build"))
    mp.setattr(native, "_LIB", None)
    assert not native.available()           # not built yet
    assert native.bytes_to_words(b"", 0, 32) is None
    native.build()
    assert native.available()
    yield native
    mp.undo()


@pytest.fixture(scope="module")
def values():
    rng = random.Random(17)
    vals = [0, 1, (1 << 256) - 1] + [rng.randrange(1 << 256)
                                     for _ in range(N - 3)]
    rng.shuffle(vals)
    return vals


def test_bytes_to_words_matches_numpy_and_reference(built, values):
    raw = bigint.ints_to_bytes(values)
    got = built.bytes_to_words(raw, N, bigint.NBYTES)
    assert got.dtype == np.int32 and got.shape == (8, N)
    np.testing.assert_array_equal(got, bigint.bytes_to_words_numpy(raw, N))
    np.testing.assert_array_equal(convert.field_to_ref(torch.from_numpy(got)),
                                  ints_to_limbs(values, 16))


@pytest.mark.parametrize("nbytes", [1, 5, 8, 31])
def test_short_records_zero_extend(built, nbytes):
    rng = random.Random(nbytes)
    vals = [rng.randrange(1 << (8 * nbytes)) for _ in range(9)]
    raw = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    got = built.bytes_to_words(raw, len(vals), nbytes)
    np.testing.assert_array_equal(got, bigint.bytes_to_words_numpy(
        bigint.ints_to_bytes(vals), len(vals)))


def test_words_to_bytes_round_trip(built, values):
    words = bigint.bytes_to_words_numpy(bigint.ints_to_bytes(values), N)
    raw = built.words_to_bytes(words)
    assert raw == bigint.words_to_bytes_numpy(words.view(np.uint32))
    assert raw == bigint.ints_to_bytes(values)


def test_bad_records_raise(built):
    with pytest.raises(ValueError):
        built.bytes_to_words(b"\0" * 33, 1, 33)
    with pytest.raises(ValueError):
        built.bytes_to_words(b"\0" * 31, 1, 32)
    with pytest.raises(ValueError):
        built.words_to_bytes(np.zeros((4, 2), np.int32))


def test_ints_to_words_with_and_without_library(built, values, monkeypatch):
    with_lib = bigint.ints_to_words(values)
    np.testing.assert_array_equal(with_lib, built.bytes_to_words(
        bigint.ints_to_bytes(values), N, bigint.NBYTES))
    back = bigint.words_to_ints(with_lib)
    monkeypatch.setattr(native, "lib", lambda: None)
    without = bigint.ints_to_words(values)
    np.testing.assert_array_equal(with_lib, without)
    assert back == bigint.words_to_ints(without) == values
