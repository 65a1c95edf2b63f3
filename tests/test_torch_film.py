"""The film's PPM ensemble average (`engine/film.py` `read_ppm`,
`average_images`) against the JAX package's, on the CPU.

- `read_ppm` reads a P3 file as the JAX package's does: a PPM the port's
  `write_ppm` wrote, and one the JAX package's wrote, give equal float64
  arrays from both readers, bit for bit, and they are the image's 8-bit
  values over 255.
- `average_images` of the same seeded gamma-encoded images equals the
  JAX package's bit for bit (both de-gamma by squaring in float64, average
  and take the square root), and of PPMs read back as the reference's
  frame-buffer ensemble averages them (`color.h:57-137`).
- `read_png` reads back the 8-bit pixels (the JAX package's `to_uint8`)
  of a PNG that the port's `write_png` wrote, and refuses a file whose
  chunk CRC is off.
"""

import numpy as np
import pytest

from raytracing_gpu_tpu.engine import film as jfilm
from raytracing_gpu_tpu_torch.engine import film


def _images(n: int, seed: int = 17, shape=(9, 13, 3)) -> list:
    rng = np.random.default_rng(seed)
    return [rng.random(shape) for _ in range(n)]


def test_read_ppm_equals_jax_on_the_ports_ppm(tmp_path):
    img = _images(1)[0]
    path = str(tmp_path / "a.ppm")
    film.write_ppm(path, img)
    got, want = film.read_ppm(path), jfilm.read_ppm(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, film.to_uint8(img) / 255.0)


def test_read_ppm_equals_jax_on_the_jax_ppm(tmp_path):
    img = _images(1, seed=5, shape=(4, 7, 3))[0]
    path = str(tmp_path / "b.ppm")
    jfilm.write_ppm(path, img)
    np.testing.assert_array_equal(film.read_ppm(path), jfilm.read_ppm(path))


def test_read_ppm_refuses_another_format(tmp_path):
    path = tmp_path / "c.ppm"
    path.write_text("P6\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="P3"):
        film.read_ppm(str(path))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_average_images_equals_jax(n):
    imgs = _images(n, seed=100 + n)
    got, want = film.average_images(imgs), jfilm.average_images(imgs)
    assert got.dtype == np.float64 and got.shape == imgs[0].shape
    np.testing.assert_array_equal(got, want)


def test_average_of_float32_images_is_float64_as_jax():
    imgs = [x.astype(np.float32) for x in _images(3, seed=3)]
    got = film.average_images(imgs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jfilm.average_images(imgs))


def test_ensemble_of_ppms_equals_jax(tmp_path):
    # the reference's frame buffers: each written as a PPM, read back and
    # averaged in linear space
    paths = []
    for i, img in enumerate(_images(4, seed=41)):
        paths.append(str(tmp_path / f"fb{i}.ppm"))
        film.write_ppm(paths[-1], film.finalize(img * 3.0, 3))
    got = film.average_images([film.read_ppm(p) for p in paths])
    want = jfilm.average_images([jfilm.read_ppm(p) for p in paths])
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0.0) & (got <= 1.0)).all()


@pytest.mark.parametrize("shape", [(5, 11, 3), (1, 1, 3)])
def test_read_png_reads_back_what_write_png_wrote(tmp_path, shape):
    img = _images(1, seed=23, shape=shape)[0]
    path = str(tmp_path / "d.png")
    film.write_png(path, img)
    got = film.read_png(path)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, jfilm.to_uint8(img))


def test_read_png_refuses_a_bad_crc(tmp_path):
    path = tmp_path / "e.png"
    film.write_png(str(path), _images(1, shape=(2, 3, 3))[0])
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF  # a byte of the IDAT chunk's data
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        film.read_png(str(path))
