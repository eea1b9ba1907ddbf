"""The port's native binding (``dualdiff_tpu_torch/data/native.py``) against
the JAX package's (``dualdiff_tpu/data/native.py``), on
``tests/test_native.py``'s three cases: the mask codec's round trip, the
6-way decode of a 1600 x 900 JPEG, a missing file.  Held bit for bit: the
two libraries are built from the same source with the same flags.  The
port's copy of the source is byte-equal to ``native/dualdiff_native.cc``
and its build writes nothing under ``native/``.

The JAX binding loads the committed ``native/libdualdiff_native.so``; the
port builds its own with ``g++`` into ``build/dualdiff_tpu_torch/`` (these
tests need g++ and libjpeg's headers); its first use may come from
several threads at once.  The card test (marker ``cuda``) holds the
native decode on that machine against the reader's own PIL path, with
``tests/test_native.py``'s mean bound.
"""

import os

import numpy as np
import pytest

from dualdiff_tpu_torch.data import native

REPO = os.path.join(os.path.dirname(__file__), "..")
NATIVE = os.path.join(REPO, "native")


def _jax_native():
    from dualdiff_tpu.data import native as jax_native

    if not jax_native.available():
        pytest.fail("the JAX binding did not load native/ (the reference)")
    return jax_native


def _smooth_jpeg(path):
    from PIL import Image

    y, x = np.mgrid[0:900, 0:1600]
    img = np.stack([(x / 1600 * 255), (y / 900 * 255),
                    ((x + y) / 2500 * 255)], -1).astype(np.uint8)
    Image.fromarray(img).save(path, quality=95)


def test_the_binding_builds_from_its_own_copy():
    st = native.status()
    assert st["path"] in ("built", "loaded"), st
    assert st["libjpeg"] and native.available()
    assert os.path.dirname(st["library"]) == native.BUILD_DIR
    with open(native.SOURCE, "rb") as a, \
            open(os.path.join(NATIVE, "dualdiff_native.cc"), "rb") as b:
        assert a.read() == b.read()


def test_pack_unpack_equal_the_jax_binding():
    jax_native = _jax_native()
    rng = np.random.default_rng(0)
    masks = (rng.random((18, 64, 48)) > 0.5).astype(np.uint8)
    packed = native.pack_masks(masks)
    assert packed.shape == (64, 48) and packed.dtype == np.uint32
    np.testing.assert_array_equal(packed, jax_native.pack_masks(masks))
    out = native.unpack_masks(packed, 18)
    np.testing.assert_array_equal(out, masks)
    np.testing.assert_array_equal(out, jax_native.unpack_masks(packed, 18))
    # and the numpy codec the reader takes without the library
    bits = ((packed[None] >> np.arange(18)[:, None, None]) & 1)
    np.testing.assert_array_equal(bits.astype(np.uint8), masks)


def test_jpeg_decode_equals_the_jax_binding(tmp_path):
    jax_native = _jax_native()
    p = str(tmp_path / "cam.jpg")
    _smooth_jpeg(p)
    out = native.load_images_batch([p] * 6, 0.25, 224, 400)
    assert out is not None and out.shape == (6, 224, 400, 3)
    np.testing.assert_array_equal(out[0], out[5])  # thread-safe
    np.testing.assert_array_equal(
        out, jax_native.load_images_batch([p] * 6, 0.25, 224, 400))


def test_missing_file_reports_failure(tmp_path):
    jax_native = _jax_native()
    for b in (native, jax_native):
        assert b.load_images_batch([str(tmp_path / "nope.jpg")], 0.25, 32,
                                   32) is None
    assert native.load_images_batch([str(tmp_path / "a.png")], 0.25, 32,
                                    32) is None  # not a JPEG


def test_a_fresh_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """A build from nothing goes to the build directory, never to
    ``native/``; without a compiler the binding says so and every call
    returns None."""
    def tree():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, fs in os.walk(NATIVE) for f in fs}

    before = tree()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_STATUS", None)
    st = native.status()
    assert st["path"] == "built" and st["build_s"] > 0
    assert os.listdir(tmp_path / "build") == [
        os.path.basename(native.library_path())]
    assert tree() == before
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_STATUS", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "other"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    st = native.status()
    assert st["path"] == "unavailable" and "no-such-g++" in st["reason"]
    assert native.pack_masks(np.zeros((2, 4, 4), np.uint8)) is None
    assert native.unpack_masks(np.zeros((4, 4), np.uint32), 2) is None
    assert tree() == before


def test_first_use_from_four_threads_builds_once(tmp_path, monkeypatch):
    """The reader's worker threads may be the first to call the binding:
    on a cold build directory, four threads that decode at once each get
    the decode (the JAX binding's), one library is built, and no temporary
    file is left."""
    import threading

    jax_native = _jax_native()
    p = str(tmp_path / "cam.jpg")
    _smooth_jpeg(p)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_STATUS", None)
    start, out = threading.Barrier(4), [None] * 4

    def work(i):
        start.wait()
        out[i] = native.load_images_batch([p] * 2, 0.25, 224, 400,
                                          num_threads=2)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = jax_native.load_images_batch([p] * 2, 0.25, 224, 400)
    for got in out:
        assert got is not None
        np.testing.assert_array_equal(got, want)
    assert native.status()["path"] == "built"
    assert os.listdir(tmp_path / "build") == [
        os.path.basename(native.library_path())]


@pytest.mark.cuda
def test_native_decode_against_the_readers_own_path_on_the_card(tmp_path):
    """On a CUDA machine (its own g++ and libjpeg): the batch decode
    within a mean of 0.03 of PIL's resize and bottom crop."""
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if not native.available():
        pytest.skip(f"no native binding there: {native.status()['reason']}")
    p = str(tmp_path / "cam.jpg")
    _smooth_jpeg(p)
    out = native.load_images_batch([p] * 6, 0.25, 224, 400)
    ref = Image.open(p).resize((400, 225), Image.BILINEAR)
    ref = np.asarray(ref.crop((0, 1, 400, 225)), np.float32) / 127.5 - 1
    assert np.abs(out[0] - ref).mean() < 0.03
