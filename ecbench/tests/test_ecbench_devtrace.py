"""The reduction from trace events to device numbers, on events made by
hand."""

import pytest

from ecbench.devtrace import Event, reduce

H2D = "Memcpy HtoD (Pinned -> Device)"
D2H = "Memcpy DtoH (Device -> Pageable)"


def _events():
    return [
        Event("ecbench.window", False, 0, 100, 1),
        Event("ecbench.issue", False, 0, 10, 1), Event("cudaMemcpyAsync", False, 2, 5, 1),
        Event("ecbench.drain", False, 20, 60, 1), Event("aten::_to_copy", False, 21, 59, 1),
        Event("cudaMemcpyAsync", False, 22, 58, 1),
        Event(H2D, True, 5, 30, 7), Event("gf_kernel", True, 30, 35, 7), Event(D2H, True, 40, 55, 7),
        Event("ecbench.drain", True, 20, 60, 7),  # the span's device shadow: not work
        Event("elsewhere", False, 70, 80, 2),  # another thread
        Event(D2H, True, 95, 110, 7),  # clipped at the window's end
    ]


def test_busy_kinds_and_window():
    r = reduce(_events())
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["h2d_s"] == pytest.approx(25e-6)
    assert r["d2h_s"] == pytest.approx(20e-6)
    assert r["kernel_s"] == pytest.approx(5e-6)


def test_idle_gaps_by_what_the_host_was_doing():
    gaps = dict(reduce(_events())["idle_gaps"])
    assert gaps["between_calls"] == pytest.approx(35e-6)
    assert gaps["ecbench.drain:cudaMemcpyAsync"] == pytest.approx(8e-6)
    assert gaps["ecbench.issue"] == pytest.approx(2e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)


def test_no_window_no_numbers():
    assert reduce([Event(H2D, True, 0, 1)]) is None
