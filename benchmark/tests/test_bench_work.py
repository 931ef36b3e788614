"""The work arithmetic of ``benchmark/work.py``."""

import pytest

from bench_common import harness  # noqa: F401  (the benchmark's modules on the path)
import work

NET = {"nb_features": 24, "nb_levels": 5, "feat_mult": 2, "nb_conv_per_level": 2}


def test_level0_conv_least_time_matches_perf_table():
    # PERF.md's kernel table: 24->24 @256^3, bound 0.528 ms by operations
    f = work.conv_flops((24,), 24, (256,) * 3)
    b = work.conv_bytes((24,), 24, (256,) * 3, "fwd")
    assert f / work.PEAK_FLOPS["bfloat16"] > b / work.PEAK_BYTES_PER_S
    assert work.least_seconds(f, b) * 1e3 == pytest.approx(0.528, abs=5e-4)


def test_unet_convs_shapes():
    convs = work.unet_convs(NET, 1, (256, 256, 256))
    assert len(convs) == 18
    assert convs[0] == ("conv_downarm_0_0", (1,), 24, (256, 256, 256))
    assert convs[9] == ("conv_downarm_4_1", (384,), 384, (16, 16, 16))
    assert convs[10] == ("conv_uparm_5_0", (192, 384), 192, (32, 32, 32))
    assert convs[-2] == ("conv_uparm_8_0", (24, 48), 24, (256, 256, 256))


@pytest.mark.parametrize("spatial,tflop,least_ms", [
    ((256, 256, 256), 10.382, 10.955),   # the predict-256 TTA pair
    ((192, 224, 192), 5.110, 5.392),     # the clinical TTA pair
])
def test_predict_work(spatial, tflop, least_ms):
    f, t = work.predict_work(NET, 1, spatial)
    assert f / 1e12 == pytest.approx(tflop, abs=1e-3)
    assert t * 1e3 == pytest.approx(least_ms, abs=1e-3)


def test_train_work_counts_fwd_dx_dw_without_first_dx():
    fwd, _ = work.conv_work(work.unet_convs(NET, 4, (128,) * 3), ("fwd",))
    first = work.conv_flops((4,), 24, (128,) * 3)
    f, t = work.train_work(NET, 4, (128,) * 3)
    assert f == pytest.approx(3 * fwd - first)
    assert fwd / 1e9 == pytest.approx(657.05, abs=0.01)
    assert 2.0e-3 < t < 2.1e-3


def test_dw_writes_float32():
    a = work.conv_bytes((24,), 24, (8, 8, 8), "dw")
    b = work.conv_bytes((24,), 24, (8, 8, 8), "dx")
    assert a - b == 27 * 24 * 24 * 2
    with pytest.raises(ValueError):
        work.conv_bytes((24,), 24, (8, 8, 8), "bwd")
