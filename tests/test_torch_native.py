"""The port's bindings to the native host runtime (utils/native.py) against
numpy and against the JAX package's bindings: tone map, flip, the PPM
files and the async frame writer, byte for byte; and the frame sink that
run, the CLI's --frames and the interactive session share, with and
without the library."""

import os

import numpy as np
import pytest

from smallpt_tpu.utils import native as jnative
from smallpt_tpu_torch.utils import image
from smallpt_tpu_torch.utils import native


@pytest.fixture
def lib():
    """The library, built with make at first use; a machine without a
    toolchain skips, as the JAX package's tests/test_native.py does."""
    if not native.available():
        pytest.skip("native library not built (no make or compiler)")
    return native


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(42)
    # out-of-gamut values and a NaN: the tone map clamps both
    data = rng.uniform(-0.2, 1.3, size=(37, 53, 3)).astype(np.float32)
    data[0, 0, 0] = np.nan
    return data


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_tonemap_matches_numpy(lib, img):
    assert np.array_equal(lib.tonemap(img), image.to_int(np.nan_to_num(img)))


def test_flip_matches_numpy(lib, img):
    got = lib.flip_y(img.copy())
    assert np.array_equal(got, img[::-1], equal_nan=True)
    with pytest.raises(ValueError, match="H, W, 3"):
        lib.flip_y(img[..., :2])


@pytest.mark.parametrize("binary", [False, True])
def test_write_ppm_bytes_match_numpy_and_jax(lib, img, binary, tmp_path):
    clean = np.nan_to_num(img)
    port, numpy_, jax_ = (str(tmp_path / f"{n}.ppm")
                          for n in ("port", "numpy", "jax"))
    lib.write_ppm(port, clean[::-1], binary=binary)
    (image.write_ppm_binary if binary else image.write_ppm)(numpy_, clean)
    jnative.write_ppm(jax_, clean[::-1], binary=binary)
    assert _bytes(port) == _bytes(numpy_) == _bytes(jax_)


def test_frame_writer_async(lib, img, tmp_path):
    clean = np.nan_to_num(img)
    pattern = str(tmp_path / "frame_%04d.ppm")
    with lib.FrameWriter(pattern, img.shape[1], img.shape[0], binary=True,
                         max_queue=2) as fw:
        for i in range(8):
            fw.push(clean[::-1] * (i + 1) / 8, i)
        with pytest.raises(ValueError, match="frame shape"):
            fw.push(clean[:5], 9)
        assert fw.errors == 0
    for i in range(8):
        ref = str(tmp_path / "ref.ppm")
        lib.write_ppm(ref, clean[::-1] * (i + 1) / 8, binary=True)
        assert _bytes(pattern % i) == _bytes(ref)


@pytest.mark.parametrize("pattern", ["f_%02d.ppm", "f_%02d.pnm"])
def test_frame_sink_native(lib, img, pattern, tmp_path):
    """A .ppm pattern gets binary P6 frames, any other ASCII P3, each the
    image flipped into file order, byte-equal to the synchronous native
    writer (and, on this image, to the numpy writers: the two tone maps
    round apart on a few values in a million, ROADMAP.md H10)."""
    clean = np.nan_to_num(img)
    pat = str(tmp_path / "sub" / pattern)
    with lib.FrameSink(pat, img.shape[1], img.shape[0]) as sink:
        assert sink.native
        sink.push(clean, 1)
    binary = pattern.endswith(".ppm")
    ref, ref_np = str(tmp_path / "ref"), str(tmp_path / "ref_np")
    lib.write_ppm(ref, clean[::-1], binary=binary)
    (image.write_ppm_binary if binary else image.write_ppm)(ref_np, clean)
    assert _bytes(pat % 1) == _bytes(ref) == _bytes(ref_np)


def test_native_and_numpy_tone_maps_round_apart_rarely(lib):
    """The native tone map raises x to 1.f / 2.2f (0.45454544), numpy's
    to_int to 1 / 2.2 rounded to float32 (0.45454547): another byte on 26
    of 9,000,000 uniform values (ROADMAP.md H10), so a frame's bytes are
    the native writer's, not the numpy writer's."""
    x = np.random.default_rng(0).uniform(0, 1.2, (3000, 1000, 3))
    x = x.astype(np.float32)
    diff = lib.tonemap(x).astype(int) - image.to_int(x).astype(int)
    assert np.abs(diff).max() <= 1 and 0 < np.count_nonzero(diff) <= 100


def test_frame_sink_falls_back_to_numpy(img, tmp_path, monkeypatch):
    """Without the library (SMALLPT_TPU_NO_NATIVE) frames are written at
    once as ASCII P3 through utils/image.py."""
    clean = np.nan_to_num(img)
    monkeypatch.setenv("SMALLPT_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.FrameWriter(str(tmp_path / "x_%d.ppm"), 4, 4)
    pat = str(tmp_path / "f_%02d.ppm")
    with native.FrameSink(pat, img.shape[1], img.shape[0]) as sink:
        assert not sink.native and sink.errors == 0
        sink.push(clean, 3)
    ref = str(tmp_path / "ref.ppm")
    image.write_ppm(ref, clean)
    assert _bytes(pat % 3) == _bytes(ref)
    assert not os.path.exists(pat % 1)
