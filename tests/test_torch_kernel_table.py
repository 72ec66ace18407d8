"""The yardsticks of `chip_smoke.py`'s kernel table, on the CPU.

The bound counts exactly the bytes an SPD solve must move, the cold timer's
flush buffer evicts the whole L2 cache it is given, a bound share above
1.05 (a kernel faster than the card's limits) is refused, and
`scripts/profile_torch_spd.py` still finds its phase markers in the
kernels' sources.  No card needed: the L2 size is a fake device's.
"""
import os
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke  # noqa: E402
import profile_torch_spd  # noqa: E402


# Sectors counted by hand.  n = 2: a system is 16 bytes, so systems 0 and 1
# share sector 0 (with both rows of each) and system 2 is sector 1.  n = 8:
# each row is one whole sector and its diagonal ends inside it.  n = 40:
# rows are 160 bytes (5 sectors), sector-aligned, and row i reads i + 1
# floats, ceil((i + 1) / 8) sectors: 8 * (1 + 2 + 3 + 4 + 5) = 120.
@pytest.mark.parametrize("batch,n,sectors", [
    (1, 2, 1), (3, 2, 2), (1, 8, 8), (3, 8, 24), (1, 40, 120), (3, 40, 360)])
def test_spd_bound_counts_lower_triangle_sectors(batch, n, sectors):
    nbytes = chip_smoke.spd_bound_bytes(batch, n)
    assert nbytes == 32 * sectors + 2 * 4 * batch * n    # + g and d
    peaks = (1e9, 1e30)                  # bytes bound it
    ms, by = chip_smoke.spd_bound_ms(batch, n, peaks)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / peaks[0])
    ms, by = chip_smoke.spd_bound_ms(batch, n, (1e30, 1e9))
    assert by == "operations" and ms > 0


@pytest.mark.parametrize("l2_bytes", [1, 4096, 50 * 2 ** 20 + 3])
def test_cold_flush_buffer_exceeds_l2(l2_bytes):
    buf = chip_smoke.l2_flush_buffer(
        "cpu", SimpleNamespace(L2_cache_size=l2_bytes))
    assert buf.numel() * buf.element_size() > 2 * l2_bytes


@pytest.mark.parametrize("bound,cold,ok", [
    (0.0102, 0.05, True), (0.0105, 0.01, True), (0.0106, 0.01, False)])
def test_bound_share_refuses_impossible_readings(bound, cold, ok):
    if ok:
        assert chip_smoke.bound_share(bound, cold, "k") == bound / cold
    else:
        with pytest.raises(AssertionError, match="impossible"):
            chip_smoke.bound_share(bound, cold, "k")


@pytest.mark.parametrize("name", ["spd_cholesky", "spd_lanes"])
def test_phase_profile_finds_its_markers(name):
    src = profile_torch_spd.instrumented(name)
    # Five clock reads (exit, factorization, two substitutions, stores),
    # the clock array and the reader.
    assert src.count("clock64()") == 5
    assert src.count("phase_clk[") == 6
    assert 'extern "C" int read_phase_clk' in src
