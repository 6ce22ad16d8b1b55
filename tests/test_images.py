"""Image IO without OpenCV (io/images.py): the PNG codec, resize and
pyramid against OpenCV's outputs, and the optional-OpenCV error path."""

import sys

import numpy as np
import pytest

from hcmvs_tpu.io import images as I


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint8), ((37, 53), np.uint16),
    ((37, 53, 3), np.uint8), ((37, 53, 3), np.uint16)],
    ids=["gray8", "gray16", "rgb8", "rgb16"])
def test_png_roundtrip(tmp_path, shape, dtype):
    rng = np.random.default_rng(0)
    a = (rng.random(shape) * np.iinfo(dtype).max).astype(dtype)
    p = str(tmp_path / "a.png")
    I.write_png(p, a)
    b = I.read_png(p)
    assert b.dtype == dtype and b.shape == a.shape
    np.testing.assert_array_equal(a, b)
    # load_image scales by the bit depth into [0, 1]
    img = I.load_image(p)
    assert img.shape[:2] == shape[:2] and img.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0


def test_png_reads_adaptive_filters(tmp_path):
    """Files from other encoders use the Sub/Up/Average/Paeth filters."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:40, 0:60]
    smooth = ((np.sin(xx / 5.0) + np.cos(yy / 7.0)) * 60 + 128)
    for a in (smooth.astype(np.uint8),
              np.stack([smooth, 255 - smooth, smooth / 2], -1).astype(
                  np.uint8),
              (rng.random((40, 60, 3)) * 65535).astype(np.uint16)):
        p = str(tmp_path / "c.png")
        cv2.imwrite(p, a[..., ::-1] if a.ndim == 3 else a)
        np.testing.assert_array_equal(I.read_png(p), a)


def test_load_image_gray_and_npy(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    rgb = (rng.random((30, 40, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "g.png")
    I.write_png(p, rgb)
    gray = I.load_image(p, gray=True)
    ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
    # libpng fixed-point luma: equal up to one grey level
    assert np.abs(gray - ref).max() <= 1.0 / 255.0 + 1e-7
    f = rng.random((30, 40)).astype(np.float32)
    np.save(str(tmp_path / "f.npy"), f)
    np.testing.assert_array_equal(I.load_image(str(tmp_path / "f.npy"),
                                               gray=True), f)


@pytest.mark.parametrize("scale", [0.5, 0.37, 1.7])
def test_resize_matches_opencv(scale):
    """Area averaging when shrinking, half-pixel linear when enlarging:
    float32 images agree with OpenCV to float32 rounding (the tolerance
    allows a few ulp of the [0, 1] values)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    for img in (rng.random((96, 128)).astype(np.float32),
                rng.random((96, 128, 3)).astype(np.float32)):
        out = I.resize_image(img, scale)
        h, w = img.shape[:2]
        size = (max(1, round(w * scale)), max(1, round(h * scale)))
        ref = cv2.resize(img, size, interpolation=(
            cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("hw", [(96, 128), (97, 131)])
def test_pyr_down_matches_opencv(hw):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(4).random(hw).astype(np.float32)
    out = I.pyr_down(img)
    ref = cv2.pyrDown(img)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert [p.shape for p in I.build_pyramid(img, 3)] == [
        hw, ref.shape, cv2.pyrDown(ref).shape]


def test_mask_resize_is_nearest():
    cv2 = pytest.importorskip("cv2")
    m = np.random.default_rng(5).integers(0, 5, (37, 53)).astype(np.int32)
    np.testing.assert_array_equal(
        I.resize_mask(m, (20, 31)),
        cv2.resize(m, (31, 20), interpolation=cv2.INTER_NEAREST))


def test_other_formats_name_the_format_without_opencv(tmp_path,
                                                      monkeypatch):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match=r"\.jpg"):
        I.load_image(str(p))
