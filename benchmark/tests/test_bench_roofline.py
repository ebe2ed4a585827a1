"""The roofline arithmetic against hand counts, and the trace reader on a
made-up trace."""
import json

import pytest

from benchmark import roofline
from benchmark import trace as tracing


def test_k1_on_512_rows_of_48000_hand_count():
    # 512 x 48000 float32 in (98.304 MB), 6 rows of it out (589.824 MB);
    # 2 filters x 8 taps x 2 flops per sample and level, 5 levels
    nbytes, flops = roofline.modwt_cascade(512, 48000, 5, 8)
    assert nbytes == 98_304_000 + 589_824_000
    assert flops == 2 * 8 * 2 * 512 * 48000 * 5
    assert roofline.bound_s(nbytes, flops) == pytest.approx(688_128_000 / 3.35e12)


def test_k1_on_a_batch_of_short_signals_hand_count():
    # 2^24 // 90 = 186413 signals of 90 samples: 67,108,680 bytes in, 6 rows out
    nbytes, flops = roofline.modwt_cascade(186413, 90, 5, 8)
    assert nbytes == 4 * 186413 * 90 * 7 == 469_760_760
    assert flops == 2 * 8 * 2 * 186413 * 90 * 5


def test_k4_pass_on_a_2048_square_image_hand_count():
    # 2048^2 float32 in and out; steps on 2048, 1024, ..., 64 samples
    nbytes, flops = roofline.pyramid_rows(2048, 2048, 6, 8)
    assert nbytes == 2 * 4 * 2048 * 2048
    assert flops == 2048 * 2 * 8 * (2048 + 1024 + 512 + 256 + 128 + 64)


def test_k3_axis_pass_at_the_volume_cell_hand_count():
    nbytes, flops = roofline.pyramid_rows(256 * 256, 256, 6, 8)
    assert nbytes == 134_217_728
    assert flops == 65536 * 2 * 8 * (256 + 128 + 64 + 32 + 16 + 8)


def test_the_pyramid_stops_at_two_samples():
    assert roofline.pyramid_rows(1, 8, 10, 2)[1] == 2 * 2 * (8 + 4 + 2)


def test_every_bound_of_the_cells_is_a_byte_bound():
    for nbytes, flops in (roofline.modwt_cascade(262144, 64, 5, 8),
                          roofline.modwt_cascade(2048, 8192, 5, 8),
                          roofline.pyramid_rows(2048, 2048, 6, 8),
                          roofline.pyramid_rows(65536, 256, 6, 8)):
        assert nbytes / roofline.HBM_BYTES_PER_S > flops / roofline.F32_FLOP_PER_S


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::modwt_fwd_kernel<float, float>(float const*, float*)", "K1"),
    ("void (anonymous namespace)::modwt_inv_kernel<float, float>(float const*)", "K2"),
    ("(anonymous namespace)::pyramid_tail_kernel(float const*, long long)", "K3"),
    ("void (anonymous namespace)::pyramid_tile_kernel<4>(float const*)", "K3"),
    ("(anonymous namespace)::pyramid_rows_t_kernel(float const*, float*)", "K4"),
    ("(anonymous namespace)::ipyramid_rows_t_kernel(float const*, float*)", "K5"),
    ("void (anonymous namespace)::ipyramid_tile_kernel<4>(float const*, float*)", "K7"),
    ("void at::native::elementwise_kernel<128, 2, at::native::direct_copy_kernel_cuda()>()", None),
    ("Memcpy DtoH (Device -> Pageable)", None),
])
def test_kernels_are_told_apart_by_symbol(name, kernel):
    assert roofline.kernel_of(name) == kernel


def _trace(tmp_path, device, spans, window=(0.0, 100.0)):
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a} for a, b, n in device]
    events += [{"ph": "X", "cat": "user_annotation", "name": "bench." + n, "ts": a, "dur": b - a}
               for a, b, n in spans]
    events.append({"ph": "X", "cat": "overhead", "name": "Activity Buffer Request", "ts": 0,
                   "dur": 100})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.load(path)


def test_busy_is_the_union_of_device_intervals_clipped_to_the_window(tmp_path):
    tr = _trace(tmp_path, [(-5, 10, "k"), (5, 20, "k"), (40, 50, "c"), (95, 130, "k")],
                [(0, 30, "call"), (2, 25, "modwt"), (30, 60, "call"), (60, 100, "wait")])
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy() == [(0.0, 20.0), (40.0, 50.0), (95.0, 100.0)]
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.gaps() == [(20.0, 40.0), (50.0, 95.0)]
    assert tr.requests == 2
    assert tr.device_seconds(lambda n: n == "c") == pytest.approx(10e-6)
    # gap 20-40 has its middle (30) in the second call; 50-95 in the wait
    assert tr.idle_by_span() == [["wait", pytest.approx(45e-6)], ["call", pytest.approx(20e-6)]]
    assert tr.device_ops()[0] == ["k", pytest.approx(30e-6)]  # 10 + 15 + 5 inside
