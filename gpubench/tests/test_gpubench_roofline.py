import pytest

from gpubench import roofline


def test_bytes_bound_spmv_by_hand():
    # 1000 stored f32 values, 1500 logical entries, 100 x 100, r = 1:
    # 4000 + (100 + 100) * 4 = 4800 bytes; 3000 operations
    nbytes, flops = roofline.product_work(1000, 1500, 100, 100, 1, "float32")
    assert (nbytes, flops) == (4800, 3000)
    s, what = roofline.product_bound(1000, 1500, 100, 100, 1, "float32")
    assert what == "bytes" and s == pytest.approx(4800 / 3.35e12)


def test_complex_operations_bound_spmm_by_hand():
    # complex64: 8 bytes a value, 8 operations a multiply-add
    nbytes, flops = roofline.product_work(10**6, 2 * 10**6, 1000, 1000, 64,
                                          "complex64")
    assert nbytes == 8 * 10**6 + 2000 * 64 * 8
    assert flops == 8 * 2 * 10**6 * 64
    s, what = roofline.product_bound(10**6, 2 * 10**6, 1000, 1000, 64,
                                     "complex64", "highest")
    assert what == "operations" and s == pytest.approx(flops / 165e12)


def test_tiers():
    assert roofline.PEAK_FLOPS["highest"] == pytest.approx(165e12)
    assert roofline.PEAK_FLOPS[None] == 495e12
    assert roofline.bound_s(0, 67e12, "float64") == (1.0, "operations")
